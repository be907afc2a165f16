// K3 and K4: the decoder tails of the medium and the high branch, for Hopper
// (sm_90a): everything after the d1 concat, as one fused launch per stage.
//
// Replace the TPU kernels adam_dehaze_tpu/ops/pallas/tail_chain.py:
// _medium_tail_kernel (K3, launched by _run_tail_medium) and _tail_kernel
// (K4, launched by _run_tail). With BatchNorm folded (ops/fold.py) the
// tails are
//
//     d2  = relu(convT4x4s2(d1) + t_up)                  4c -> c, 2x upsample
//     d2  = relu(conv_b(relu(conv_a(d2) + ta)) + tb + d2)    ResidualBlock
//     K4: g  = sigmoid(mlp(mean_hw(d2)) + mlp(max_hw(d2)))   channel gate
//         z  = d2 * g;  d2 = z * sigmoid(conv7x7([mean_c, max_c](z)))
//     h   = relu(conv([d2, f0]) + t1)                    2c -> c, no concat
//     h   = relu(conv(h) + t2)                           c -> c/2
//     res = tanh(conv(h) + bias)                         c/2 -> 3
//     K3: out = clip(x + res, 0, 1)
//     K4: gd  = sigmoid(conv1x1(relu(conv(relu(conv(x))))))  3 -> 16 -> 16 -> 1
//         out = clip(x + res * gd, 0, 1)
//
// What bounds them on an H100: operations. At batch 16 and 256^2 K4 is
// 1.1 TFLOP and K3 0.49 TFLOP of convolution against some 0.3-0.4 GB of
// inputs and output. The TPU kernels keep a whole image resident in VMEM
// between the stages; one 256^2 x 96 bf16 activation is 12 MiB against
// 227 KB of shared memory, so here every stage is one launch and the
// activations between stages make a round trip through device memory in
// the compute dtype. Fusing stages with halo recompute is later work.
//
// Design. One conv kernel serves every convolution of the tails:
// - a block computes an 8x16 tile of output positions for up to 32 output
//   channels (grid.z walks wider outputs and, for the transposed conv, the
//   four sub-pixel phases: phase (a, b) is a 2x2-tap conv whose outputs go
//   to pixels (2m + a, 2n + b));
// - the input channels are walked in chunks of 32: each chunk's tile (with
//   its halo, zero outside the image) and weights are staged in shared
//   memory and accumulated into registers, so any width fits one block and
//   a second input (f0 beside d2 for the first head conv) is just more
//   chunks: the concat is never written;
// - two bodies: bf16 with all widths multiples of 16 runs on the tensor
//   cores (nvcuda::wmma 16x16x16, one warp per tile row, f32 accumulators
//   kept in fragments across the chunks); everything else (fp32, the
//   3-channel input and output layers) runs f32 FMAs, one pixel and 8
//   output channels per thread;
// - epilogues in f32 before one rounding: shift, optional residual (in
//   place), ReLU; or, for the last layer, tanh, the guidance head's 1x1
//   conv and sigmoid, the blend with the input image and the clip, written
//   as f32.
// K4's attention block is four more kernels: a two-stage (deterministic)
// per-image channel reduction, the two-layer MLP with its sigmoid, a pass
// that writes the channel-gated activation (rounded to the compute dtype,
// as the TPU kernel does) and the f32 (mean, max) maps over channels with
// their zero border, and the 7x7 stencil with the spatial gate, which is
// K2' (csrc/cbam_gate.cu: spatial_gate). The maps stay f32, as K2's do; the
// TPU kernel rounds them to the compute dtype to reuse a VMEM buffer.
#include <cmath>
#include <cstdint>

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kPix = kTileH * kTileW;       // output positions per block
constexpr int kCoChunk = 32;                // output channels per block
constexpr int kKc = 32;                     // input channels per staged chunk
constexpr int kMaxTilePix = (kTileH + 2) * (kTileW + 2);

struct ConvArgs {
  const void* in[2];     // sources, NHWC (N, H, W, c[s]); in[1] may be null
  const void* w[2];      // weights (phases, taps, c[s], Cout) in the compute dtype
  int c[2];
  const float* shift;    // (Cout)
  const void* residual;  // null or like out; may alias out
  void* out;             // (N, H * up, W * up, Cout) in the compute dtype
  int H, W, Cout;
  int ksize;             // 3: 3x3 taps, pad 1; 2: sub-pixel phases of 2x2 taps
  int relu;
  // The last layer (Cout = 3) only:
  const void* image;     // (N, H, W, 3) compute dtype
  const void* guidance;     // null (K3) or (N, H, W, gc) compute dtype
  const float* guidance_w;  // (gc) f32
  float guidance_b;
  int gc;
  float* out_f32;        // (N, H, W, 3)
};

struct Geometry {
  int tw, th, taps, phase, pa, pb, off_y, off_x, co0, nco, tx0, ty0, n;
};

__device__ __forceinline__ Geometry geometry(const ConvArgs& a) {
  Geometry g;
  const int k = a.ksize;
  g.tw = kTileW + k - 1;
  g.th = kTileH + k - 1;
  g.taps = k * k;
  const int n_chunks = (a.Cout + kCoChunk - 1) / kCoChunk;
  g.phase = blockIdx.z / n_chunks;
  g.co0 = (blockIdx.z % n_chunks) * kCoChunk;
  g.nco = min(kCoChunk, a.Cout - g.co0);
  g.pa = g.phase >> 1;
  g.pb = g.phase & 1;
  // 3x3: taps reach from -1; phase (a, b): tap (u, v) reads (m - 1 + a + u, n - 1 + b + v).
  g.off_y = k == 3 ? -1 : g.pa - 1;
  g.off_x = k == 3 ? -1 : g.pb - 1;
  const int tiles_x = (a.W + kTileW - 1) / kTileW;
  g.tx0 = (blockIdx.x % tiles_x) * kTileW;
  g.ty0 = (blockIdx.x / tiles_x) * kTileH;
  g.n = blockIdx.y;
  return g;
}

// Where output position (y, x) of this block's phase lands in `out`.
__device__ __forceinline__ size_t out_pixel(const ConvArgs& a, const Geometry& g, int y, int x) {
  if (a.ksize == 3) return (static_cast<size_t>(g.n) * a.H + y) * a.W + x;
  return (static_cast<size_t>(g.n) * 2 * a.H + 2 * y + g.pa) * (2 * a.W) + 2 * x + g.pb;
}

// ---- f32 FMA body ----------------------------------------------------------
constexpr int kFmaStride = kKc + 1;   // neighbouring pixels in different banks
constexpr int kFmaTileFloats = (kMaxTilePix * kFmaStride + 3) & ~3;
constexpr size_t kFmaSmem = (kFmaTileFloats + 9 * kKc * kCoChunk) * sizeof(float);

template <typename T, bool kFinal>
__global__ void __launch_bounds__(kPix * 4)
tail_conv_fma_kernel(ConvArgs a) {
  extern __shared__ float smem[];
  float* s_in = smem;                      // [tile pixel][kFmaStride]
  float* s_w = smem + kFmaTileFloats;      // [tap][kKc][kCoChunk]
  const Geometry g = geometry(a);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int px = threadIdx.x % kTileW;
  const int py = threadIdx.x / kTileW;
  const int grp = threadIdx.y;  // 8 output channels
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int s = 0; s < 2; ++s) {
    const int C = a.c[s];
    if (a.in[s] == nullptr || C == 0) continue;
    const T* in = static_cast<const T*>(a.in[s]);
    const T* wgt = static_cast<const T*>(a.w[s]) + static_cast<size_t>(g.phase) * g.taps * C * a.Cout;
    for (int c0 = 0; c0 < C; c0 += kKc) {
      const int kc = min(kKc, C - c0);
      __syncthreads();   // the chunk before is consumed
      if (C % 8 == 0) {
        const int vec_per_pix = kc / 8;
        for (int i = tid; i < g.th * g.tw * vec_per_pix; i += nthreads) {
          const int p = i / vec_per_pix;
          const int v = i - p * vec_per_pix;
          const int yy = g.ty0 + g.off_y + p / g.tw;
          const int xx = g.tx0 + g.off_x + p % g.tw;
          float vals[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W)
            adam::Vec8<T>::load(
                in + ((static_cast<size_t>(g.n) * a.H + yy) * a.W + xx) * C + c0 + v * 8, vals);
#pragma unroll
          for (int k = 0; k < 8; ++k) s_in[p * kFmaStride + v * 8 + k] = vals[k];
        }
      } else {
        for (int i = tid; i < g.th * g.tw * kc; i += nthreads) {
          const int p = i / kc;
          const int ci = i - p * kc;
          const int yy = g.ty0 + g.off_y + p / g.tw;
          const int xx = g.tx0 + g.off_x + p % g.tw;
          float v = 0.f;
          if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W)
            v = adam::to_float(in[((static_cast<size_t>(g.n) * a.H + yy) * a.W + xx) * C + c0 + ci]);
          s_in[p * kFmaStride + ci] = v;
        }
      }
      // Weight rows (tap * C + c0 + ci) of Cout columns; zero beyond nco.
      for (int i = tid; i < g.taps * kc * kCoChunk; i += nthreads) {
        const int co = i % kCoChunk;
        const int r = i / kCoChunk;
        const int tap = r / kc;
        const int ci = r - tap * kc;
        s_w[(tap * kKc + ci) * kCoChunk + co] =
            co < g.nco
                ? adam::to_float(wgt[(static_cast<size_t>(tap) * C + c0 + ci) * a.Cout + g.co0 + co])
                : 0.f;
      }
      __syncthreads();
      for (int ky = 0; ky < a.ksize; ++ky) {
        for (int kx = 0; kx < a.ksize; ++kx) {
          const float* ip = s_in + ((py + ky) * g.tw + px + kx) * kFmaStride;
          const float* wp = s_w + (ky * a.ksize + kx) * kKc * kCoChunk + grp * 8;
          for (int ci = 0; ci < kc; ++ci) {
            const float v = ip[ci];
            const float4 w0 = *reinterpret_cast<const float4*>(wp + ci * kCoChunk);
            const float4 w1 = *reinterpret_cast<const float4*>(wp + ci * kCoChunk + 4);
            acc[0] = fmaf(v, w0.x, acc[0]); acc[1] = fmaf(v, w0.y, acc[1]);
            acc[2] = fmaf(v, w0.z, acc[2]); acc[3] = fmaf(v, w0.w, acc[3]);
            acc[4] = fmaf(v, w1.x, acc[4]); acc[5] = fmaf(v, w1.y, acc[5]);
            acc[6] = fmaf(v, w1.z, acc[6]); acc[7] = fmaf(v, w1.w, acc[7]);
          }
        }
      }
    }
  }

  const int y = g.ty0 + py;
  const int x = g.tx0 + px;
  if (y >= a.H || x >= a.W) return;
  const size_t pix = out_pixel(a, g, y, x);
  if constexpr (kFinal) {
    if (grp != 0) return;
    float gd = 1.f;
    if (a.guidance != nullptr) {
      const T* gp = static_cast<const T*>(a.guidance) + pix * a.gc;
      float d = a.guidance_b;
      for (int k = 0; k < a.gc; ++k) d = fmaf(adam::to_float(gp[k]), a.guidance_w[k], d);
      gd = 1.f / (1.f + expf(-d));
    }
    const T* img = static_cast<const T*>(a.image);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float res = tanhf(acc[k] + a.shift[k]);
      const float v = adam::to_float(img[pix * 3 + k]) + res * gd;
      a.out_f32[pix * 3 + k] = fminf(fmaxf(v, 0.f), 1.f);
    }
  } else {
    T* out = static_cast<T*>(a.out);
    const T* residual = static_cast<const T*>(a.residual);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int local = grp * 8 + k;
      if (local >= g.nco) break;
      const int co = g.co0 + local;
      const size_t o = pix * a.Cout + co;
      float r = acc[k] + a.shift[co];
      if (residual != nullptr) r += adam::to_float(residual[o]);
      if (a.relu) r = fmaxf(r, 0.f);
      out[o] = adam::from_float<T>(r);
    }
  }
}

template <typename T, bool kFinal>
int launch_fma(const ConvArgs& a, int N, cudaStream_t stream) {
  cudaError_t err = adam::allow_dynamic_smem(tail_conv_fma_kernel<T, kFinal>, kFmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((a.H + kTileH - 1) / kTileH) * ((a.W + kTileW - 1) / kTileW);
  const int groups = (min(a.Cout, kCoChunk) + 7) / 8;
  const int phases = a.ksize == 3 ? 1 : 4;
  const dim3 grid(tiles, N, phases * ((a.Cout + kCoChunk - 1) / kCoChunk));
  const dim3 block(kPix, groups);
  tail_conv_fma_kernel<T, kFinal><<<grid, block, kFmaSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 tensor-core body -------------------------------------------------
constexpr int kMmaThreads = 32 * kTileH;    // one warp per tile row
constexpr int kMmaStride = kKc + 16;        // every fragment pointer 32-byte aligned
constexpr size_t kMmaTileBytes = (size_t(kMaxTilePix) * kMmaStride * 2 + 127) & ~size_t(127);
constexpr size_t kMmaWeightBytes = size_t(9) * kKc * kCoChunk * 2;
constexpr size_t kMmaSmem = kMmaTileBytes + kMmaWeightBytes + size_t(kPix) * kCoChunk * 4;

__global__ void __launch_bounds__(kMmaThreads)
tail_conv_mma_kernel(ConvArgs a) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem_raw + kMmaTileBytes);
  float* s_acc = reinterpret_cast<float*>(smem_raw + kMmaTileBytes + kMmaWeightBytes);
  const Geometry g = geometry(a);
  const int tid = threadIdx.x;
  const int row = tid / 32;          // this warp's tile row: 16 positions
  const int nfrag = g.nco / 16;      // 1 or 2 output fragments of 16 channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;

  for (int s = 0; s < 2; ++s) {
    const int C = a.c[s];
    if (a.in[s] == nullptr || C == 0) continue;
    const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(a.in[s]);
    const __nv_bfloat16* wgt =
        static_cast<const __nv_bfloat16*>(a.w[s]) + static_cast<size_t>(g.phase) * g.taps * C * a.Cout;
    for (int c0 = 0; c0 < C; c0 += kKc) {
      const int kc = min(kKc, C - c0);   // 16 or 32
      __syncthreads();   // the chunk before is consumed
      const int vec_per_pix = kc / 8;
      for (int i = tid; i < g.th * g.tw * vec_per_pix; i += kMmaThreads) {
        const int p = i / vec_per_pix;
        const int v = i - p * vec_per_pix;
        const int yy = g.ty0 + g.off_y + p / g.tw;
        const int xx = g.tx0 + g.off_x + p % g.tw;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W)
          val = *reinterpret_cast<const uint4*>(
              in + ((static_cast<size_t>(g.n) * a.H + yy) * a.W + xx) * C + c0 + v * 8);
        *reinterpret_cast<uint4*>(s_in + p * kMmaStride + v * 8) = val;
      }
      const int wvec = g.nco / 8;
      for (int i = tid; i < g.taps * kc * wvec; i += kMmaThreads) {
        const int v = i % wvec;
        const int r = i / wvec;
        const int tap = r / kc;
        const int ci = r - tap * kc;
        *reinterpret_cast<uint4*>(s_w + (tap * kKc + ci) * kCoChunk + v * 8) =
            *reinterpret_cast<const uint4*>(
                wgt + (static_cast<size_t>(tap) * C + c0 + ci) * a.Cout + g.co0 + v * 8);
      }
      __syncthreads();
      for (int ky = 0; ky < a.ksize; ++ky) {
        for (int kx = 0; kx < a.ksize; ++kx) {
          const __nv_bfloat16* arow = s_in + ((row + ky) * g.tw + kx) * kMmaStride;
          const __nv_bfloat16* wtap = s_w + (ky * a.ksize + kx) * kKc * kCoChunk;
          for (int k16 = 0; k16 < kc; k16 += 16) {
            // A: 16 positions x 16 input channels, position stride kMmaStride.
            wmma::load_matrix_sync(fa, arow + k16, kMmaStride);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              if (f < nfrag) {
                wmma::load_matrix_sync(fb, wtap + k16 * kCoChunk + f * 16, kCoChunk);
                wmma::mma_sync(acc[f], fa, fb, acc[f]);
              }
            }
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

  // Epilogue: consecutive threads on consecutive channels of a position.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const __nv_bfloat16* residual = static_cast<const __nv_bfloat16*>(a.residual);
  for (int i = tid; i < kPix * g.nco; i += kMmaThreads) {
    const int p = i / g.nco;
    const int c = i - p * g.nco;
    const int y = g.ty0 + p / kTileW;
    const int x = g.tx0 + p % kTileW;
    if (y >= a.H || x >= a.W) continue;
    const size_t o = out_pixel(a, g, y, x) * a.Cout + g.co0 + c;
    float v = s_acc[p * kCoChunk + c] + a.shift[g.co0 + c];
    if (residual != nullptr) v += __bfloat162float(residual[o]);
    if (a.relu) v = fmaxf(v, 0.f);
    out[o] = __float2bfloat16(v);
  }
}

int launch_mma(const ConvArgs& a, int N, cudaStream_t stream) {
  cudaError_t err = adam::allow_dynamic_smem(tail_conv_mma_kernel, kMmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((a.H + kTileH - 1) / kTileH) * ((a.W + kTileW - 1) / kTileW);
  const int phases = a.ksize == 3 ? 1 : 4;
  const dim3 grid(tiles, N, phases * ((a.Cout + kCoChunk - 1) / kCoChunk));
  tail_conv_mma_kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4's attention block --------------------------------------------------
constexpr int kRedThreads = 256;

// Stage 1 of the per-image channel reduction: block (slab, n) reduces its
// slab of pixels to one (sum, max) per channel. partial: (N, slabs, 2, C).
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int P, int C,
                     int slab_pixels) {
  __shared__ float s_sum[kRedThreads * 8];
  __shared__ float s_max[kRedThreads * 8];
  const int cg = C / 8;                   // channel vectors per pixel
  const int pg = kRedThreads / cg;        // pixels in flight
  const int tid = threadIdx.x;
  const int lane_c = tid % cg;
  const int lane_p = tid / cg;
  const int n = blockIdx.y;
  const int slab = blockIdx.x;
  const int p0 = slab * slab_pixels;
  const int p1 = min(P, p0 + slab_pixels);
  float sum[8], mx[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) { sum[k] = 0.f; mx[k] = -INFINITY; }
  if (lane_p < pg) {
    for (int p = p0 + lane_p; p < p1; p += pg) {
      float v[8];
      adam::Vec8<T>::load(x + (static_cast<size_t>(n) * P + p) * C + lane_c * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) { sum[k] += v[k]; mx[k] = fmaxf(mx[k], v[k]); }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s_sum[lane_p * C + lane_c * 8 + k] = sum[k];
      s_max[lane_p * C + lane_c * 8 + k] = mx[k];
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kRedThreads) {
    float s = 0.f, m = -INFINITY;
    for (int q = 0; q < pg; ++q) { s += s_sum[q * C + c]; m = fmaxf(m, s_max[q * C + c]); }
    float* dst = partial + (static_cast<size_t>(n) * gridDim.x + slab) * 2 * C;
    dst[c] = s;
    dst[C + c] = m;
  }
}

// Stage 2 and the MLP: g[n, c] = sigmoid(mlp(mean)[c] + mlp(max)[c]),
// mlp(v) = w1 @ relu(w0 @ v); w0 (hidden, C), w1 (C, hidden), f32.
__global__ void channel_gate_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ w0, const float* __restrict__ w1,
                                    float* __restrict__ gate, int slabs, int P, int C,
                                    int hidden) {
  extern __shared__ float s[];
  float* s_avg = s;
  float* s_max = s + C;
  float* s_ha = s + 2 * C;
  float* s_hm = s_ha + hidden;
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  for (int c = tid; c < C; c += blockDim.x) {
    float sum = 0.f, m = -INFINITY;
    for (int q = 0; q < slabs; ++q) {
      const float* src = partial + (static_cast<size_t>(n) * slabs + q) * 2 * C;
      sum += src[c];
      m = fmaxf(m, src[C + c]);
    }
    s_avg[c] = sum / static_cast<float>(P);
    s_max[c] = m;
  }
  __syncthreads();
  for (int j = tid; j < hidden; j += blockDim.x) {
    float ha = 0.f, hm = 0.f;
    for (int c = 0; c < C; ++c) {
      ha = fmaf(s_avg[c], w0[j * C + c], ha);
      hm = fmaf(s_max[c], w0[j * C + c], hm);
    }
    s_ha[j] = fmaxf(ha, 0.f);
    s_hm[j] = fmaxf(hm, 0.f);
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float ya = 0.f, ym = 0.f;
    for (int j = 0; j < hidden; ++j) {
      ya = fmaf(s_ha[j], w1[c * hidden + j], ya);
      ym = fmaf(s_hm[j], w1[c * hidden + j], ym);
    }
    gate[static_cast<size_t>(n) * C + c] = 1.f / (1.f + expf(-(ya + ym)));
  }
}

// z = x * g rounded to the compute dtype, and the f32 (mean, max) maps of z
// over channels (of the unrounded products, as on the TPU) with a zero
// border of 3: one thread per pixel of the padded maps.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
gated_stats_kernel(const T* __restrict__ x, const float* __restrict__ gate, T* __restrict__ z,
                   float* __restrict__ mean_p, float* __restrict__ max_p, int H, int W, int C) {
  extern __shared__ float s_g[];
  const int n = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kRedThreads) s_g[c] = gate[static_cast<size_t>(n) * C + c];
  __syncthreads();
  const int Wp = W + 6;
  const int q = blockIdx.x * kRedThreads + threadIdx.x;
  if (q >= (H + 6) * Wp) return;
  const int y = q / Wp - 3;
  const int xx = q % Wp - 3;
  float mean = 0.f, mx = 0.f;
  if (y >= 0 && y < H && xx >= 0 && xx < W) {
    const size_t base = ((static_cast<size_t>(n) * H + y) * W + xx) * C;
    float sum = 0.f;
    mx = -INFINITY;
    for (int c = 0; c < C; c += 8) {
      float v[8];
      adam::Vec8<T>::load(x + base + c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] *= s_g[c + k];
        sum += v[k];
        mx = fmaxf(mx, v[k]);
      }
      adam::Vec8<T>::store(z + base + c, v);
    }
    mean = sum / static_cast<float>(C);
  }
  const size_t o = static_cast<size_t>(n) * (H + 6) * Wp + q;
  mean_p[o] = mean;
  max_p[o] = mx;
}

}  // namespace

// One convolution of a tail: out = act(conv(in0; w0) [+ conv(in1; w1)] +
// shift [+ residual]). ksize 3: 3x3 taps, pad 1, out (N, H, W, Cout).
// ksize 2: the four sub-pixel phases of ConvTranspose(4, stride 2, pad 1),
// weights (4, 4, c0, Cout) [phase, tap], out (N, 2H, 2W, Cout). in1 may be
// null. residual may equal out: each element is read, then written, by one
// thread. Channel counts must be multiples of 8 except a single input of
// any width through the scalar path.
extern "C" int tail_conv(const void* in0, const void* w0, int c0, const void* in1,
                         const void* w1, int c1, const void* shift, const void* residual,
                         void* out, int N, int H, int W, int Cout, int ksize, int relu,
                         int is_bf16, void* stream) {
  if ((ksize != 2 && ksize != 3) || c0 < 1 || Cout < 1 || (in1 != nullptr && c1 < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  a.in[0] = in0; a.w[0] = w0; a.c[0] = c0;
  a.in[1] = in1; a.w[1] = w1; a.c[1] = in1 != nullptr ? c1 : 0;
  a.shift = static_cast<const float*>(shift);
  a.residual = residual;
  a.out = out;
  a.H = H; a.W = W; a.Cout = Cout; a.ksize = ksize; a.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && c0 % 16 == 0 && a.c[1] % 16 == 0 && Cout % 16 == 0) return launch_mma(a, N, s);
  if (is_bf16) return launch_fma<__nv_bfloat16, false>(a, N, s);
  return launch_fma<float, false>(a, N, s);
}

// The last layer: out_f32 = clip(image + tanh(conv3x3(h; w) + bias) * gd, 0, 1),
// gd = sigmoid(guidance . guidance_w + guidance_b) per pixel, or 1 when guidance is null.
extern "C" int tail_conv_final(const void* h, const void* w, int cin, const void* bias,
                               const void* image, const void* guidance, int gc,
                               const void* guidance_w, float guidance_b, void* out_f32, int N,
                               int H, int W, int is_bf16, void* stream) {
  if (cin < 1 || (guidance != nullptr && gc < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  a.in[0] = h; a.w[0] = w; a.c[0] = cin;
  a.shift = static_cast<const float*>(bias);
  a.H = H; a.W = W; a.Cout = 3; a.ksize = 3;
  a.image = image;
  a.guidance = guidance;
  a.guidance_w = static_cast<const float*>(guidance_w);
  a.guidance_b = guidance_b;
  a.gc = gc;
  a.out_f32 = static_cast<float*>(out_f32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_fma<__nv_bfloat16, true>(a, N, s);
  return launch_fma<float, true>(a, N, s);
}

// Stage 1 of the channel reduction of x (N, P, C): partial (N, slabs, 2, C).
extern "C" int tail_channel_stats(const void* x, void* partial, int N, int P, int C, int slabs,
                                  int is_bf16, void* stream) {
  if (C % 8 != 0 || C / 8 > kRedThreads || slabs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slab_pixels = (P + slabs - 1) / slabs;
  const dim3 grid(slabs, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(partial);
  if (is_bf16)
    channel_stats_kernel<__nv_bfloat16><<<grid, kRedThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), dst, P, C, slab_pixels);
  else
    channel_stats_kernel<float><<<grid, kRedThreads, 0, s>>>(static_cast<const float*>(x), dst,
                                                             P, C, slab_pixels);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 and the MLP: gate (N, C) f32 from partial, w0 (hidden, C), w1 (C, hidden).
extern "C" int tail_channel_gate(const void* partial, const void* w0, const void* w1,
                                 void* gate, int N, int slabs, int P, int C, int hidden,
                                 void* stream) {
  const size_t smem = (2 * static_cast<size_t>(C) + 2 * hidden) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  channel_gate_kernel<<<N, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<float*>(gate), slabs, P, C, hidden);
  return static_cast<int>(cudaGetLastError());
}

// z = x * gate (compute dtype) and the padded f32 maps (N, H+6, W+6) of z.
extern "C" int tail_gated_stats(const void* x, const void* gate, void* z, void* mean_p,
                                void* max_p, int N, int H, int W, int C, int is_bf16,
                                void* stream) {
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (C % 8 != 0 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((H + 6) * (W + 6) + kRedThreads - 1) / kRedThreads, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gate);
  float* mp = static_cast<float*>(mean_p);
  float* xp = static_cast<float*>(max_p);
  if (is_bf16)
    gated_stats_kernel<__nv_bfloat16><<<grid, kRedThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, static_cast<__nv_bfloat16*>(z), mp, xp, H, W, C);
  else
    gated_stats_kernel<float><<<grid, kRedThreads, smem, s>>>(
        static_cast<const float*>(x), g, static_cast<float*>(z), mp, xp, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
