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
// conv_tile.cu, whose note says how it is built (bf16: wgmma on 16x16
// positions by up to 128 output channels a block, input channels in stages
// of 16 through an asynchronous ring, so the first head conv reads f0
// beside d2 as more stages and the concat is never written; the transposed
// conv as four sub-pixel phases; FMAs for fp32 and the 3-channel layers;
// the last layer's tanh, guidance, blend and clip as its epilogue, launched
// from here). The Python wrapper launches it per layer through
// ops/kernels/conv_tile.py; K6 runs the same kernel. In bf16 at c = 32 or
// 64 K3's last two layers (c -> c/2 and c/2 -> 3 with tanh, x + res and the
// clip) are instead one launch of a fused group on wgmma, beside K1's groups
// (lightweight_chain.cu: tail_head_group): 5 launches, not 6.
// K4's attention block is four more kernels: a two-stage (deterministic)
// per-image channel reduction, the two-layer MLP with its sigmoid, a pass
// that writes the channel-gated activation (rounded to the compute dtype,
// as the TPU kernel does) and the f32 (mean, max) maps over channels with
// their zero border, and the 7x7 stencil with the spatial gate, which is
// K2' (csrc/cbam_gate.cu: spatial_gate). The maps stay f32, as K2's do; the
// TPU kernel rounds them to the compute dtype to reuse a VMEM buffer.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "conv_tile.cuh"

namespace {

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

// The last layer: out_f32 = clip(image + tanh(conv3x3(h; w) + bias) * gd, 0, 1),
// gd = sigmoid(guidance . guidance_w + guidance_b) per pixel, or 1 when guidance is null.
extern "C" int tail_conv_final(const void* h, const void* w, int cin, const void* bias,
                               const void* image, const void* guidance, int gc,
                               const void* guidance_w, float guidance_b, void* out_f32, int N,
                               int H, int W, int is_bf16, void* stream) {
  if (cin < 1 || (guidance != nullptr && gc < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  adam::ConvArgs a = {};
  a.in[0] = h; a.w[0] = w; a.c[0] = cin;
  a.shift = static_cast<const float*>(bias);
  a.H = H; a.W = W; a.Cout = 3; a.ksize = 3;
  a.image = image;
  a.guidance = guidance;
  a.guidance_w = static_cast<const float*>(guidance_w);
  a.guidance_b = guidance_b;
  a.gc = gc;
  a.out_f32 = static_cast<float*>(out_f32);
  return adam::launch_conv_final(a, N, is_bf16, static_cast<cudaStream_t>(stream));
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
