// K2 and K2': the fused CBAM gate of AttentionBlock, for Hopper (sm_90a).
//
// K2 (entry point cbam_gate) replaces the TPU kernel
// adam_dehaze_tpu/ops/pallas/cbam.py:_kernel_cgate (launched by
// channel_spatial_gate_pallas); K2' (entry point spatial_gate) replaces
// cbam.py:_kernel (launched by spatial_gate_pallas), which is K2 with the
// channel gate fixed at 1: the same device code compiled without the read
// of g, so that no tensor of ones exists. K2 computes
//
//     out = (x * g) * sigmoid(conv7x7([mean_c, max_c](x * g)))   zero pad 3
//
// for x (B, H, W, C) NHWC in float or bf16, the channel gate g (B, C) f32,
// the (mean, max) maps of the gated tensor zero-padded by 3 on every side,
// (B, H+6, W+6) f32 each, and the stencil w (7, 7, 2) f32.
//
// What bounds it on an H100: memory. Per element it does two multiplies and
// the two reductions; the stencil is 98 FMAs per pixel, shared by all C
// channels. The least traffic is x read once and the result written once,
// 2 * B*H*W*C * sizeof(T) bytes, against 3.35 TB/s. On the TPU the maps were
// reduced by XLA in one fused read of x; here they are a kernel of this file
// too (entry point cbam_gated_maps), so that a call is two launches and no
// PyTorch reduction:
//
// 1. gated_maps_kernel reads x once and writes only the padded maps. A pixel
//    is reduced by a sub-group of S lanes (S the largest power of two that
//    divides C / 8, at most 32), each lane loading 16-byte vectors S apart,
//    so that every lane of a warp loads whatever C is (C = 96: 4 lanes a
//    pixel, 3 vectors each; a warp a pixel left 20 of 32 lanes idle); the
//    sub-group is reduced by shuffles; the zero border is written by index,
//    without a read.
// 2. cbam_gate_kernel: one block per (row tile of kTileH rows, image). The
//    block stages the maps' rows it needs, with the 3-pixel halo, in shared
//    memory, computes the 98-tap stencil and the sigmoid once per pixel into
//    shared memory, then streams x * g * gate over the tile's contiguous
//    H*W*C range in vectors of 8 elements (16-byte loads for bf16; C is a
//    multiple of 8). Each block re-reads only its rows plus the 6 halo rows
//    of the maps, (kTileH+6)/kTileH of a map read, small beside x.
//
// Two launches read x twice (1.5x the least traffic). The other design, one
// persistent cooperative launch that reduces image n, passes a grid barrier
// and gates image n while x is still in the 50 MB L2, was not built: see
// PERF.md for the two launches' times beside the bound.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kHalo = 3;
constexpr int kTileH = 4;
constexpr int kThreads = 256;

// kChannelGate = false is K2': g is never read.
template <typename T, bool kChannelGate>
__global__ void __launch_bounds__(kThreads)
cbam_gate_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ mean_p, const float* __restrict__ max_p,
                 const float* __restrict__ w, T* __restrict__ out,
                 int H, int W, int C) {
  extern __shared__ float smem[];
  __shared__ float s_w[98];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTileH;
  const int rows = min(kTileH, H - row0);
  const int Wp = W + 2 * kHalo;
  const int srows = rows + 2 * kHalo;
  float* s_mean = smem;
  float* s_max = s_mean + (kTileH + 2 * kHalo) * Wp;
  float* s_gate = s_max + (kTileH + 2 * kHalo) * Wp;

  const int tid = threadIdx.x;
  if (tid < 98) s_w[tid] = w[tid];
  // Padded row r of the maps is image row r - 3, so the tile's rows
  // row0 .. row0+rows-1 need padded rows row0 .. row0+rows+5.
  const size_t map_off = (static_cast<size_t>(b) * (H + 2 * kHalo) + row0) * Wp;
  for (int i = tid; i < srows * Wp; i += kThreads) {
    s_mean[i] = mean_p[map_off + i];
    s_max[i] = max_p[map_off + i];
  }
  __syncthreads();

  for (int p = tid; p < rows * W; p += kThreads) {
    const int r = p / W;
    const int c = p - r * W;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      const float* mrow = s_mean + (r + i) * Wp + c;
      const float* xrow = s_max + (r + i) * Wp + c;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        acc = fmaf(mrow[j], s_w[(i * 7 + j) * 2], acc);
        acc = fmaf(xrow[j], s_w[(i * 7 + j) * 2 + 1], acc);
      }
    }
    s_gate[p] = 1.f / (1.f + __expf(-acc));
  }
  __syncthreads();

  // The tile's rows are one contiguous range of x: rows*W*C elements.
  const size_t base = (static_cast<size_t>(b) * H + row0) * W * C;
  const float* gb = kChannelGate ? g + static_cast<size_t>(b) * C : nullptr;
  const int n_vec = rows * W * (C / 8);
  for (int v = tid; v < n_vec; v += kThreads) {
    const int e = v * 8;
    const int pix = e / C;
    const int ch = e - pix * C;
    const float gate = s_gate[pix];
    float vals[8];
    adam::Vec8<T>::load(x + base + e, vals);
    if constexpr (kChannelGate) {
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(gb + ch));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(gb + ch + 4));
      const float gk[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) vals[k] *= gk[k] * gate;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) vals[k] *= gate;
    }
    adam::Vec8<T>::store(out + base + e, vals);
  }
}

template <typename T, bool kChannelGate>
int launch(const void* x, const void* g, const void* mean_p, const void* max_p,
           const void* w, void* out, int B, int H, int W, int C, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(kTileH + 2 * kHalo) * (W + 2 * kHalo) +
       static_cast<size_t>(kTileH) * W) * sizeof(float);
  if (C % 8 != 0 || smem > adam::kMaxDynamicSmem - 98 * sizeof(float))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = adam::allow_dynamic_smem(cbam_gate_kernel<T, kChannelGate>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + kTileH - 1) / kTileH, B);
  cbam_gate_kernel<T, kChannelGate><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(mean_p), static_cast<const float*>(max_p),
      static_cast<const float*>(w), static_cast<T*>(out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}


// ---- the statistics pass ---------------------------------------------------
constexpr int kMapThreads = 256;
constexpr int kMapPasses = 8;     // pixels per sub-group and block

// The f32 (mean, max) maps over channels of x * g (of x when kChannelGate is
// false: g is never read), with a zero border of 3. S lanes reduce a pixel.
template <typename T, bool kChannelGate>
__global__ void __launch_bounds__(kMapThreads)
gated_maps_kernel(const T* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ mean_p, float* __restrict__ max_p, int H, int W, int C,
                  int S) {
  extern __shared__ float s_g[];
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  if constexpr (kChannelGate) {
    for (int c = tid; c < C; c += kMapThreads) s_g[c] = g[static_cast<size_t>(n) * C + c];
    __syncthreads();
  }
  const int Wp = W + 2 * kHalo;
  const size_t map0 = static_cast<size_t>(n) * (H + 2 * kHalo) * Wp;
  float* mp = mean_p + map0;
  float* xp = max_p + map0;
  // The border by index: 3 rows above, 3 below, 3 columns on either side.
  const int n_border = 2 * kHalo * (Wp + H);
  for (int e = blockIdx.x * kMapThreads + tid; e < n_border; e += gridDim.x * kMapThreads) {
    int o;
    if (e < kHalo * Wp) {
      o = e;
    } else if (e < 2 * kHalo * Wp) {
      o = (H + kHalo) * Wp + e - kHalo * Wp;
    } else {
      const int k = e - 2 * kHalo * Wp;
      const int side = k % (2 * kHalo);
      o = (k / (2 * kHalo) + kHalo) * Wp + (side < kHalo ? side : W + side);
    }
    mp[o] = 0.f;
    xp[o] = 0.f;
  }
  const int per_lane = C / 8 / S;             // vectors a lane reduces
  const int slots = kMapThreads / S;          // pixels a pass
  const int slot = tid / S, s = tid % S;
  const int pixels = H * W;
  for (int pass = 0; pass < kMapPasses; ++pass) {
    const int p = (blockIdx.x * kMapPasses + pass) * slots + slot;
    float sum = 0.f, mx = -INFINITY;
    if (p < pixels) {
      const T* px = x + (static_cast<size_t>(n) * pixels + p) * C;
      for (int i = 0; i < per_lane; ++i) {
        const int v = i * S + s;
        float vals[8];
        adam::Vec8<T>::load(px + v * 8, vals);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float z = kChannelGate ? vals[k] * s_g[v * 8 + k] : vals[k];
          sum += z;
          mx = fmaxf(mx, z);
        }
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (p < pixels && s == 0) {
      const int y = p / W;
      const int o = (y + kHalo) * Wp + p - y * W + kHalo;
      mp[o] = sum / static_cast<float>(C);
      xp[o] = mx;
    }
  }
}

template <typename T, bool kChannelGate>
int launch_maps(const void* x, const void* g, void* mean_p, void* max_p, int B, int H, int W,
                int C, cudaStream_t stream) {
  const size_t smem = kChannelGate ? static_cast<size_t>(C) * sizeof(float) : 0;
  if (C % 8 != 0 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int S = 1;
  while (S < 32 && (C / 8) % (2 * S) == 0) S *= 2;
  const int per_block = kMapPasses * (kMapThreads / S);
  const dim3 grid((H * W + per_block - 1) / per_block, B);
  gated_maps_kernel<T, kChannelGate><<<grid, kMapThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g), static_cast<float*>(mean_p),
      static_cast<float*>(max_p), H, W, C, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The statistics pass of K2 and K2': the padded f32 maps (B, H+6, W+6) of
// x * g over channels, g (B, C) f32; g null: the maps of x itself.
extern "C" int cbam_gated_maps(const void* x, const void* g, void* mean_p, void* max_p,
                               int B, int H, int W, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g != nullptr)
    return is_bf16 ? launch_maps<__nv_bfloat16, true>(x, g, mean_p, max_p, B, H, W, C, s)
                   : launch_maps<float, true>(x, g, mean_p, max_p, B, H, W, C, s);
  return is_bf16 ? launch_maps<__nv_bfloat16, false>(x, g, mean_p, max_p, B, H, W, C, s)
                 : launch_maps<float, false>(x, g, mean_p, max_p, B, H, W, C, s);
}

extern "C" int cbam_gate(const void* x, const void* g, const void* mean_p,
                         const void* max_p, const void* w, void* out, int B, int H,
                         int W, int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, g, mean_p, max_p, w, out, B, H, W, C, s);
  return launch<float, true>(x, g, mean_p, max_p, w, out, B, H, W, C, s);
}

// K2': out = x * sigmoid(conv7x7([mean_c, max_c](x))), the maps of x itself
// zero-padded by 3, f32, as for cbam_gate.
extern "C" int spatial_gate(const void* x, const void* mean_p, const void* max_p,
                            const void* w, void* out, int B, int H, int W, int C,
                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, nullptr, mean_p, max_p, w, out, B, H, W, C, s);
  return launch<float, false>(x, nullptr, mean_p, max_p, w, out, B, H, W, C, s);
}
