// K6: one same-shape segment of eval-mode ResidualBlocks and CBAM
// AttentionBlocks, for Hopper (sm_90a).
//
// Replaces the TPU kernel adam_dehaze_tpu/ops/pallas/res_chain.py:
// _chain_kernel (launched by _run_chain, built by make_res_attn_chain). With
// BatchNorm folded (ops/fold.py) a segment is a list of
//
//     res:  a = relu(conv3x3(b; k0) + t0);  b = relu(conv3x3(a; k1) + t1 + b)
//     attn: g  = sigmoid(mlp(mean_hw(b)) + mlp(max_hw(b)))      channel gate
//           zp = b * g                               f32, never rounded
//           b  = zp * sigmoid(conv7x7([mean_c, max_c](zp)))     one rounding
//
// on an activation (N, H, W, C) NHWC in the compute dtype; sums, shifts, the
// MLP, the maps and the stencil are f32. These are the TPU kernel's rounding
// points. (K4's attention step differs: it rounds zp before the spatial
// gate.)
//
// What bounds it on an H100: operations. A res block is 36 c^2 FLOP per
// pixel; the high branch's 64^2 x 384 segment is 87 GFLOP per image against
// 3 MiB of activation. The TPU kernel keeps the activation of a whole image
// resident in VMEM across the segment; 3 MiB does not fit 227 KB of shared
// memory, so here every conv and every attention pass is one launch and the
// activation makes a round trip through device memory, mostly through the
// 50 MB L2, between them. Keeping it on chip across layers (a cluster of
// blocks per image, or halo recompute) is later work.
//
// Design. The convs are conv_tile.cu, shared with the tail chains and
// launched per layer by the Python wrapper through ops/kernels/conv_tile.py
// (bf16: wgmma on 16x16 positions by 128 or 96 output channels a block,
// input channels in stages of 16 through an asynchronous ring, so 384 ->
// 384 fits a block; the skip add in the epilogue, in place). An attention block
// is four launches: the two-stage channel reduction and the MLP are the
// tail chains' (tail_channel_stats, tail_channel_gate in tail_chain.cu); the
// kernel below writes the padded f32 (mean, max) maps of b * g without
// writing b * g; and K2 (cbam_gate.cu) computes b * g * gate in f32 with
// the unrounded stencil and rounds once.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMapThreads = 256;
constexpr int kMapWarps = kMapThreads / 32;
constexpr int kPixPerWarp = 8;

// The f32 (mean, max) maps over channels of x * gate, with a zero border of
// 3: one warp per pixel of the padded maps, lanes across the channel
// vectors, a shuffle reduction at the end. Nothing but the maps is written.
template <typename T>
__global__ void __launch_bounds__(kMapThreads)
gated_maps_kernel(const T* __restrict__ x, const float* __restrict__ gate,
                  float* __restrict__ mean_p, float* __restrict__ max_p, int H, int W, int C) {
  extern __shared__ float s_g[];
  const int n = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kMapThreads)
    s_g[c] = gate[static_cast<size_t>(n) * C + c];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int Wp = W + 6;
  const int padded = (H + 6) * Wp;
  const int q0 = (blockIdx.x * kMapWarps + warp) * kPixPerWarp;
  const int vecs = C / 8;
  for (int q = q0; q < min(q0 + kPixPerWarp, padded); ++q) {
    const int y = q / Wp - 3;
    const int xx = q % Wp - 3;
    float sum = 0.f, mx = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W) {
      const T* px = x + ((static_cast<size_t>(n) * H + y) * W + xx) * C;
      mx = -INFINITY;
      for (int v = lane; v < vecs; v += 32) {
        float vals[8];
        adam::Vec8<T>::load(px + v * 8, vals);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float z = vals[k] * s_g[v * 8 + k];
          sum += z;
          mx = fmaxf(mx, z);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      sum /= static_cast<float>(C);
    }
    if (lane == 0) {
      const size_t o = static_cast<size_t>(n) * padded + q;
      mean_p[o] = sum;
      max_p[o] = mx;
    }
  }
}

}  // namespace

// The padded f32 maps (N, H+6, W+6) of x * gate over channels; gate (N, C) f32.
extern "C" int res_chain_gated_maps(const void* x, const void* gate, void* mean_p, void* max_p,
                                    int N, int H, int W, int C, int is_bf16, void* stream) {
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (C % 8 != 0 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kMapWarps * kPixPerWarp;
  const dim3 grid(((H + 6) * (W + 6) + per_block - 1) / per_block, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gate);
  float* mp = static_cast<float*>(mean_p);
  float* xp = static_cast<float*>(max_p);
  if (is_bf16)
    gated_maps_kernel<__nv_bfloat16><<<grid, kMapThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, mp, xp, H, W, C);
  else
    gated_maps_kernel<float><<<grid, kMapThreads, smem, s>>>(static_cast<const float*>(x), g, mp,
                                                             xp, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
