// K1: the eval-mode low branch (LightweightDehazeModel) for Hopper (sm_90a),
// as one fused 3x3-convolution launch per layer.
//
// Replaces the TPU kernel adam_dehaze_tpu/ops/pallas/s2d_chain.py:
// _lightweight_kernel (launched by _run_chain, built by
// make_lightweight_chain_apply). With BatchNorm folded into each conv's
// weights and shift (ops/fold.py), the branch is
//
//     h = relu(conv(x) + t0)                          ConvBlock 3 -> c
//     h = relu(conv_b(relu(conv_a(h) + ta)) + tb + h)  x n_blocks
//     h = relu(conv(h) + tm)                          ConvBlock c -> c
//     out = (1 - alpha) * x + alpha * sigmoid(conv(h) + bias)   c -> 3
//
// What bounds it on an H100: the TPU kernel keeps a whole image resident in
// VMEM between layers; that cannot work here (one 256x256x32 bf16 activation
// is 4 MiB against 227 KB of shared memory per block). So each layer is one
// launch, and each inter-layer activation makes a round trip through device
// memory in the compute dtype, as the TPU kernel stores them (bf16 or f32).
// At batch 16 and 256^2 an activation is 64 MiB, beyond the 50 MB L2; the
// c -> c layers carry 2*9*c*c FLOP per pixel, 19 GFLOP per c=32 layer.
//
// Design: a block computes an 8x16 output tile for up to 32 output channels
// (grid.z walks wider outputs). It stages the input tile with a 1-pixel zero
// halo and the layer's folded weights for its channel chunk in shared
// memory. Two bodies, chosen by dtype and shape before the launch:
// - bf16 with Cin and Cout multiples of 16 (the c -> c layers at c=32):
//   tensor cores through warp-level bf16 MMA (nvcuda::wmma, 16x16x16,
//   fp32 accumulators). Each of the 8 warps owns one tile row of 16 pixels
//   and accumulates its implicit-GEMM product over the 9 taps x Cin; the
//   accumulators go through shared memory to the epilogue.
// - everything else (fp32, and the 3-channel input and output layers):
//   fp32 FMAs on the CUDA cores. Each thread owns one pixel and 8 output
//   channels; the input tile is staged as f32 at row stride Cin+1 (so
//   neighbouring pixels fall in different banks) and a warp shares its 8
//   weights per input channel as two broadcast float4 loads.
// The epilogue adds the shift, the optional residual (read from the output
// buffer itself when the residual block updates in place) and the ReLU, or
// the sigmoid and the alpha blend with the input image for the output
// layer. Later PRs: several layers per launch with halo recompute, so that
// activations stay on chip, and wgmma with TMA-fed tiles.
#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kPix = kTileH * kTileW;   // threads along x: one per pixel
constexpr int kCoChunk = 32;            // output channels per block

__host__ __device__ inline int in_tile_floats(int cin) {
  // Rounded up to 4 floats so the weight array after it is float4-aligned.
  return (((kTileH + 2) * (kTileW + 2) * (cin + 1)) + 3) & ~3;
}

inline size_t smem_bytes(int cin) {
  return (static_cast<size_t>(in_tile_floats(cin)) + 9 * cin * kCoChunk) * sizeof(float);
}

// kBlend = false: out[T] = act(conv(in) + shift [+ residual]).
// kBlend = true: out_f32 = (1 - alpha) * x_in + alpha * sigmoid(conv(in) + shift).
template <typename T, bool kBlend>
__global__ void __launch_bounds__(kPix * 4)
conv3x3_kernel(const T* __restrict__ in, const T* __restrict__ wgt,
               const float* __restrict__ shift, const T* residual, T* out,
               const T* __restrict__ x_in, float* __restrict__ out_f32, float alpha,
               int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ float smem[];
  float* s_in = smem;
  float* s_w = smem + in_tile_floats(Cin);
  const int cinp = Cin + 1;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int n = blockIdx.y;
  const int co0 = blockIdx.z * kCoChunk;
  const int nco = min(kCoChunk, Cout - co0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  constexpr int kTilePix = (kTileH + 2) * (kTileW + 2);
  for (int i = tid; i < kTilePix * Cin; i += nthreads) {
    const int p = i / Cin;
    const int ci = i - p * Cin;
    const int yy = ty0 - 1 + p / (kTileW + 2);
    const int xx = tx0 - 1 + p % (kTileW + 2);
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = adam::to_float(in[((static_cast<size_t>(n) * H + yy) * W + xx) * Cin + ci]);
    s_in[p * cinp + ci] = v;
  }
  // Weights are HWIO (3, 3, Cin, Cout); the chunk is staged as
  // s_w[(tap * Cin + ci) * kCoChunk + co], zero beyond nco.
  for (int i = tid; i < 9 * Cin * kCoChunk; i += nthreads) {
    const int co = i % kCoChunk;
    const int tc = i / kCoChunk;
    s_w[i] = co < nco ? adam::to_float(wgt[static_cast<size_t>(tc) * Cout + co0 + co]) : 0.f;
  }
  __syncthreads();

  const int px = threadIdx.x % kTileW;
  const int py = threadIdx.x / kTileW;
  const int grp = threadIdx.y;  // 8 output channels
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const float* ip = s_in + ((py + ky) * (kTileW + 2) + px + kx) * cinp;
      const float* wp = s_w + (ky * 3 + kx) * Cin * kCoChunk + grp * 8;
      for (int ci = 0; ci < Cin; ++ci) {
        const float a = ip[ci];
        const float4 w0 = *reinterpret_cast<const float4*>(wp + ci * kCoChunk);
        const float4 w1 = *reinterpret_cast<const float4*>(wp + ci * kCoChunk + 4);
        acc[0] = fmaf(a, w0.x, acc[0]); acc[1] = fmaf(a, w0.y, acc[1]);
        acc[2] = fmaf(a, w0.z, acc[2]); acc[3] = fmaf(a, w0.w, acc[3]);
        acc[4] = fmaf(a, w1.x, acc[4]); acc[5] = fmaf(a, w1.y, acc[5]);
        acc[6] = fmaf(a, w1.z, acc[6]); acc[7] = fmaf(a, w1.w, acc[7]);
      }
    }
  }

  const int y = ty0 + py;
  const int x = tx0 + px;
  if (y >= H || x >= W) return;
  const size_t pix = (static_cast<size_t>(n) * H + y) * W + x;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int local = grp * 8 + k;
    if (local >= nco) break;
    const int co = co0 + local;
    const float v = acc[k] + shift[co];
    const size_t o = pix * Cout + co;
    if constexpr (kBlend) {
      const float s = 1.f / (1.f + expf(-v));
      out_f32[o] = (1.f - alpha) * adam::to_float(x_in[o]) + alpha * s;
    } else {
      float r = v;
      if (residual != nullptr) r += adam::to_float(residual[o]);
      if (relu) r = fmaxf(r, 0.f);
      out[o] = adam::from_float<T>(r);
    }
  }
}

template <typename T, bool kBlend>
int launch(const void* in, const void* w, const void* shift, const void* residual,
           void* out, const void* x_in, float* out_f32, float alpha, int N, int H,
           int W, int Cin, int Cout, int relu, cudaStream_t stream) {
  const size_t smem = smem_bytes(Cin);
  if (Cin < 1 || Cout < 1 || smem > adam::kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = adam::allow_dynamic_smem(conv3x3_kernel<T, kBlend>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  const int groups = (min(Cout, kCoChunk) + 7) / 8;
  const dim3 grid(tiles, N, (Cout + kCoChunk - 1) / kCoChunk);
  const dim3 block(kPix, groups);
  conv3x3_kernel<T, kBlend><<<grid, block, smem, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(w),
      static_cast<const float*>(shift), static_cast<const T*>(residual),
      static_cast<T*>(out), static_cast<const T*>(x_in), out_f32, alpha, H, W, Cin,
      Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 tensor-core body -------------------------------------------------
constexpr int kMmaThreads = 32 * kTileH;  // one warp per tile row

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) & ~size_t(127); }

// Shared memory: input tile bf16 [(kTileH+2) * (kTileW+2)][Cin+16] (a pixel
// stride that keeps every fragment pointer 32-byte aligned), weights bf16
// [9 * Cin][kCoChunk], accumulators f32 [kPix][kCoChunk].
inline size_t mma_smem_bytes(int cin) {
  return align128(size_t((kTileH + 2) * (kTileW + 2)) * (cin + 16) * 2) +
         align128(size_t(9) * cin * kCoChunk * 2) + size_t(kPix) * kCoChunk * 4;
}

__global__ void __launch_bounds__(kMmaThreads)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ in,
                   const __nv_bfloat16* __restrict__ wgt,
                   const float* __restrict__ shift, const __nv_bfloat16* residual,
                   __nv_bfloat16* out, int H, int W, int Cin, int Cout, int relu) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int cinp = Cin + 16;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + align128(size_t((kTileH + 2) * (kTileW + 2)) * cinp * 2));
  float* s_acc = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_w) + align128(size_t(9) * Cin * kCoChunk * 2));

  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int n = blockIdx.y;
  const int co0 = blockIdx.z * kCoChunk;
  const int nco = min(kCoChunk, Cout - co0);
  const int tid = threadIdx.x;

  // Stage the input tile, 8 channels (16 bytes) at a time, zero outside.
  constexpr int kTilePix = (kTileH + 2) * (kTileW + 2);
  const int vec_per_pix = Cin / 8;
  for (int i = tid; i < kTilePix * vec_per_pix; i += kMmaThreads) {
    const int p = i / vec_per_pix;
    const int v = i - p * vec_per_pix;
    const int yy = ty0 - 1 + p / (kTileW + 2);
    const int xx = tx0 - 1 + p % (kTileW + 2);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      val = *reinterpret_cast<const uint4*>(
          in + ((static_cast<size_t>(n) * H + yy) * W + xx) * Cin + v * 8);
    *reinterpret_cast<uint4*>(s_in + p * cinp + v * 8) = val;
  }
  // Stage the chunk's weights: HWIO rows (tap * Cin + ci) of nco columns.
  const int wvec = nco / 8;
  for (int i = tid; i < 9 * Cin * wvec; i += kMmaThreads) {
    const int tc = i / wvec;
    const int v = i - tc * wvec;
    *reinterpret_cast<uint4*>(s_w + tc * kCoChunk + v * 8) =
        *reinterpret_cast<const uint4*>(wgt + static_cast<size_t>(tc) * Cout + co0 + v * 8);
  }
  __syncthreads();

  const int row = tid / 32;       // this warp's tile row: 16 pixels
  const int nfrag = nco / 16;     // 1 or 2 output fragments of 16 channels
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const __nv_bfloat16* arow = s_in + ((row + ky) * (kTileW + 2) + kx) * cinp;
      const __nv_bfloat16* wtap = s_w + (ky * 3 + kx) * Cin * kCoChunk;
      for (int kc = 0; kc < Cin; kc += 16) {
        // A: 16 pixels x 16 input channels, pixel stride cinp.
        wmma::load_matrix_sync(a, arow + kc, cinp);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (f < nfrag) {
            wmma::load_matrix_sync(b, wtap + kc * kCoChunk + f * 16, kCoChunk);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    if (f < nfrag)
      wmma::store_matrix_sync(s_acc + row * 16 * kCoChunk + f * 16, acc[f], kCoChunk,
                              wmma::mem_row_major);
  __syncthreads();

  // Epilogue: consecutive threads on consecutive channels of a pixel.
  for (int i = tid; i < kPix * nco; i += kMmaThreads) {
    const int p = i / nco;
    const int c = i - p * nco;
    const int y = ty0 + p / kTileW;
    const int x = tx0 + p % kTileW;
    if (y >= H || x >= W) continue;
    const size_t o = ((static_cast<size_t>(n) * H + y) * W + x) * Cout + co0 + c;
    float v = s_acc[p * kCoChunk + c] + shift[co0 + c];
    if (residual != nullptr) v += __bfloat162float(residual[o]);
    if (relu) v = fmaxf(v, 0.f);
    out[o] = __float2bfloat16(v);
  }
}

int launch_mma(const void* in, const void* w, const void* shift, const void* residual,
               void* out, int N, int H, int W, int Cin, int Cout, int relu,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(Cin);
  if (smem > adam::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = adam::allow_dynamic_smem(conv3x3_mma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
  const dim3 grid(tiles, N, (Cout + kCoChunk - 1) / kCoChunk);
  conv3x3_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(in), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(shift), static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

// The body a layer runs: tensor cores for bf16 with Cin and Cout multiples of 16.
inline bool uses_mma(int cin, int cout, int is_bf16) {
  return is_bf16 && cin % 16 == 0 && cout % 16 == 0;
}

}  // namespace

// Shared memory one block of this layer's body needs, or -1 when that is
// beyond Hopper's per-block limit (the launch then refuses the layer).
// ops/kernels/lightweight_chain.py mirrors this rule to choose K1 by shape
// on any device; tests/test_torch_cuda.py holds the two against each other.
extern "C" int conv3x3_smem_bytes(int Cin, int Cout, int is_bf16) {
  const size_t smem = uses_mma(Cin, Cout, is_bf16) ? mma_smem_bytes(Cin) : smem_bytes(Cin);
  return smem > adam::kMaxDynamicSmem ? -1 : static_cast<int>(smem);
}

// One ConvBlock or residual half: out = act(conv3x3(x) + shift [+ residual]).
// residual may equal out (the residual block's in-place update): each
// element is read and then written by the same thread.
extern "C" int conv3x3_bn_act(const void* x, const void* w, const void* shift,
                              const void* residual, void* out, int N, int H, int W,
                              int Cin, int Cout, int relu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uses_mma(Cin, Cout, is_bf16))
    return launch_mma(x, w, shift, residual, out, N, H, W, Cin, Cout, relu, s);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, w, shift, residual, out, nullptr, nullptr,
                                        0.f, N, H, W, Cin, Cout, relu, s);
  return launch<float, false>(x, w, shift, residual, out, nullptr, nullptr, 0.f, N, H,
                              W, Cin, Cout, relu, s);
}

// The output layer: out_f32 = (1 - alpha) * x_in + alpha * sigmoid(conv3x3(h) + shift),
// with x_in the branch input in the compute dtype (Cout channels).
extern "C" int conv3x3_sigmoid_blend(const void* h, const void* w, const void* shift,
                                     const void* x_in, void* out, float alpha, int N,
                                     int H, int W, int Cin, int Cout, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(h, w, shift, nullptr, nullptr, x_in, o, alpha,
                                       N, H, W, Cin, Cout, 0, s);
  return launch<float, true>(h, w, shift, nullptr, nullptr, x_in, o, alpha, N, H, W,
                             Cin, Cout, 0, s);
}
