// The convolution that the chain kernels share (K3 and K4 in tail_chain.cu,
// K6 in res_chain.cu): one tile kernel for every layer, for Hopper (sm_90a).
//
// - a block computes an 8x16 tile of output positions for up to 32 output
//   channels (grid.z walks wider outputs and, for the transposed conv, the
//   four sub-pixel phases: phase (a, b) is a 2x2-tap conv whose outputs go
//   to pixels (2m + a, 2n + b));
// - the input channels are walked in chunks of 32: each chunk's tile (with
//   its halo, zero outside the image) and weights are staged in shared
//   memory and accumulated into registers, so any width fits one block and
//   a second input is just more chunks: a concat is never written;
// - two bodies: bf16 with all widths multiples of 16 runs on the tensor
//   cores (nvcuda::wmma 16x16x16, one warp per tile row, f32 accumulators
//   kept in fragments across the chunks); everything else (fp32, 3-channel
//   input and output layers) runs f32 FMAs, one pixel and 8 output channels
//   per thread;
// - epilogues in f32 before one rounding: shift, optional residual (in
//   place), ReLU; or, for a tail's last layer, tanh, the guidance head's 1x1
//   conv and sigmoid, the blend with the input image and the clip, written
//   as f32.
//
// Everything here sits in an unnamed namespace: each source that includes
// the header compiles its own copy of the kernels, so that the sources stay
// independent translation units of one library.
#pragma once

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
conv_tile_fma_kernel(ConvArgs a) {
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
  cudaError_t err = adam::allow_dynamic_smem(conv_tile_fma_kernel<T, kFinal>, kFmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((a.H + kTileH - 1) / kTileH) * ((a.W + kTileW - 1) / kTileW);
  const int groups = (min(a.Cout, kCoChunk) + 7) / 8;
  const int phases = a.ksize == 3 ? 1 : 4;
  const dim3 grid(tiles, N, phases * ((a.Cout + kCoChunk - 1) / kCoChunk));
  const dim3 block(kPix, groups);
  conv_tile_fma_kernel<T, kFinal><<<grid, block, kFmaSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 tensor-core body -------------------------------------------------
constexpr int kMmaThreads = 32 * kTileH;    // one warp per tile row
constexpr int kMmaStride = kKc + 16;        // every fragment pointer 32-byte aligned
constexpr size_t kMmaTileBytes = (size_t(kMaxTilePix) * kMmaStride * 2 + 127) & ~size_t(127);
constexpr size_t kMmaWeightBytes = size_t(9) * kKc * kCoChunk * 2;
constexpr size_t kMmaSmem = kMmaTileBytes + kMmaWeightBytes + size_t(kPix) * kCoChunk * 4;

__global__ void __launch_bounds__(kMmaThreads)
conv_tile_mma_kernel(ConvArgs a) {
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
  cudaError_t err = adam::allow_dynamic_smem(conv_tile_mma_kernel, kMmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((a.H + kTileH - 1) / kTileH) * ((a.W + kTileW - 1) / kTileW);
  const int phases = a.ksize == 3 ? 1 : 4;
  const dim3 grid(tiles, N, phases * ((a.Cout + kCoChunk - 1) / kCoChunk));
  conv_tile_mma_kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One convolution that is not a tail's last layer: the tensor-core body for
// bf16 with every width a multiple of 16, the FMA body otherwise.
inline int launch_conv(const ConvArgs& a, int N, int is_bf16, cudaStream_t stream) {
  if (is_bf16 && a.c[0] % 16 == 0 && a.c[1] % 16 == 0 && a.Cout % 16 == 0)
    return launch_mma(a, N, stream);
  if (is_bf16) return launch_fma<__nv_bfloat16, false>(a, N, stream);
  return launch_fma<float, false>(a, N, stream);
}

}  // namespace
