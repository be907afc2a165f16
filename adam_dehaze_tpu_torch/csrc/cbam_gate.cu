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
// (B, H+6, W+6) f32 each, and the stencil w (7, 7, 2) f32. The maps are
// reduced outside the kernel in f32 by the wrapper, as on the TPU.
//
// What bounds it on an H100: memory. Per element it does two multiplies; the
// stencil is 98 FMAs per pixel, shared by all C channels. x is read once and
// the result written once, 2 * B*H*W*C * sizeof(T) bytes, against 3.35 TB/s.
//
// Design: one block per (row tile of kTileH rows, image). The block stages
// the stats rows it needs, with the 3-pixel halo, in shared memory, computes
// the 98-tap stencil and the sigmoid once per pixel into shared memory, then
// streams x * g * gate over the tile's contiguous H*W*C range in vectors of
// 8 elements (16-byte loads for bf16; C is a multiple of 8). The TPU kernel
// kept whole-image stats resident in VMEM across H tiles; here each block
// re-reads only its rows plus the 6 halo rows, which costs (kTileH+6)/kTileH
// of a map read, small beside x.
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

}  // namespace

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
