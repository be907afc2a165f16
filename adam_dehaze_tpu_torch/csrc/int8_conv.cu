// Q1 and Q2: the int8 serving path of the dehazing branches, for Hopper
// (sm_90a).
//
// Together they replace AQT's int8 conv, which the JAX package swaps into
// every ConvBlock under int8 serving (adam_dehaze_tpu/ops/quant.py:34
// `_make_int8_conv`; XLA's conv on int8 operands, not a Pallas kernel). The
// arithmetic is AQT's, as ops/quant.py writes it down: one scale per image
// for the activations, one per output channel for the weights, every step
// rounded to the compute dtype T (float or bf16).
//
// Q1 (entry point int8_quantize): x (N, H, W, C) NHWC in T ->
//   q (N, H, W, cin_pad) int8, the channels zero-padded to the conv's K step,
//   scale (N,) f32 holding a value of T:
//     amax  = max |x| over the image, 0 -> 1
//     scale = T(amax * float(1 / 127.5))     (XLA's jit form of amax / 127.5)
//     q     = round_half_even(clip(T(x * T(1 / scale)), -127, 127))
//   What bounds it: memory, one read of x and one write of q against
//   3.35 TB/s. Every byte of x is needed twice (the abs-max, then the
//   quantizing pass). ONE cooperative launch of resident blocks walks the
//   batch in groups of at most kQMaxGroup images (the per-image maxima and
//   scales a block keeps in shared memory): it takes the abs-max of group s
//   (each thread's items as one flat range, four loads in flight; a running
//   maximum per image that goes to the block's maximum in shared memory
//   where the items cross into the next image, and the block's to the
//   image's by an atomic max on the float's bits, which orders as the value
//   for non-negative floats), arrives on group s's counter, waits on group
//   s - 1's (every block arrived a step before, so the wait rarely stalls)
//   and quantizes group s - 1, each thread's items in reverse (the newest
//   bytes first, so the last images read come from the 50 MB L2 and the
//   rest from memory). In bf16 the abs-max, the product by 1 / scale and the
//   clip take two values an instruction (bf16x2).
//   Where a group of processes splits each image (its rows over a spatial
//   axis, parallel/spatial.py), the abs-max must be reduced over the group
//   between the two passes, so they are also two entry points: int8_absmax
//   writes the abs-max of this process's part of each image (N,) f32, the
//   caller reduces it over the group, and int8_quantize_at quantizes at the
//   group's abs-max, its scale computed as above (the same image_scale), so
//   a shard's q and scale are the one launch's on the whole image bit for
//   bit. Each walks the batch as the one launch does, with no wait.
//
// Q2 (entry point int8_conv): a convolution on int8 tensor cores with int32
//   sums, two bodies chosen by the layer's shape (ops/kernels/quant.py:
//   ConvGeometry names the body; neither is a fallback for the other):
//
//   The tile body (3x3 stride 1 pad 1 and 4x4 stride 2 pad 1 layers whose
//   input has at least 16 channels and whose output a multiple of 16): the
//   design of conv_tile.cu's bf16 body on `wgmma.mma_async m64nNk32.s32.s8.s8`.
//   - A block owns 16x16 output positions by N output channels (N = 96, 64,
//     48, 32 or 16, the widest that divides Cout, 96 at 3x3 only; Cout is not
//     padded): two warpgroups, each two m64 accumulators (8x8 patches) in
//     registers over the whole K walk. Both int8 operands are K-major. Two
//     blocks an SM: the epilogue (below) costs about as much as the
//     products, and a second block's products run under it; measured on the
//     card, a 128-wide chunk (one block an SM) lost to 64 at every 128-,
//     256- and 384-wide layer, and a 96-wide one at 4x4 stride 2 (one
//     block) to 64.
//   - A without im2col: a stage is 32 input channels. Its input tile (halo
//     included, zero outside the image) is staged by cp.async in the
//     no-swizzle core-matrix layout [16-channel group][tile pixel][16 bytes],
//     so a tap is only a start offset of the A descriptor and one k32 step
//     covers the two groups. A 3x3 stage holds the 18x18 tile (10.6 KB).
//   - The 4x4 stride-2 layers: output (y, x) reads input (2y - 1 + ky,
//     2x - 1 + kx). The 34x34 input tile is split into four parity planes
//     (even/odd row x even/odd column) of 17x17 pixels; tap (2a + py, 2b + px)
//     reads plane (py, px) at (y + a, x + b), an offset like a 2x2 conv's. A
//     stage is 32 channels of ONE row parity: its two planes (18.5 KB) and
//     the 8 taps that read them, so a stage at N = 64 is 34.9 KB and three
//     slots fit two blocks an SM (104.8 KB each), where the whole 16-tap
//     stage (69.8 KB) would fit one slot; the K walk has twice the stages
//     of the channel groups.
//   - B by bulk copy: the weights are packed once per (output chunk, stage)
//     slab, contiguous in the slot's layout [tap][16-channel group][N / 8]
//     [8 outputs][16 bytes], and one cp.async.bulk onto the slot's mbarrier
//     fills a slot (3x3 at N = 96: 27.6 KB).
//   - A ring of slots: four, or three where four would not let two blocks
//     share an SM (the byte counts are conv_tile.cu's bf16 body's: 32 int8
//     channels a stage are the bytes of 16 bf16 ones). Loads run two stages
//     ahead (one with three slots) and `wgmma.wait_group 1` keeps the tensor
//     cores busy across the barrier.
//   - Bound: operations, 2 * M * Cout * K against 1,979 TOPS of int8.
//
//   The gather body (every other layer: the RGB inputs, cin_pad 4, of the
//   7x7 stems and the 3x3 first convs, and shapes the tile body does not
//   take): an implicit GEMM on `mma.sync.m16n8k32.s32.s8.s8.s32`, 128 x 64
//   tiles, 8 warps of 32 x 32, K in steps of 64 bytes through a 3-stage
//   cp.async ring, the A tile gathered per thread (4-byte copies of one
//   tap's channels at cin_pad 4, 16-byte copies at multiples of 16), the
//   weights packed OHWI (cout_pad, k_pad). Those layers are thin: they are
//   bound by bytes, and this body is faster than cuDNN's bf16 conv on the
//   7x7 stems.
//
//   The epilogue of both bodies: the block's int32 sums go through shared
//   memory, and each thread then takes one channel octet of a run of output
//   pixels, its channels' parameters in registers, four pixels at a time,
//   and stores 16 bytes (bf16) or 32 bytes (f32) a pixel: the same code for
//   every element, and few instructions, since the epilogue is what the
//   tile body spends most on after its products. Per element: AQT's
//   dequant exactly as the plain version rounds it, T(float(acc)), times
//   the image's scale, rounded to T, times the channel's scale, rounded to
//   T (in bf16 two elements at once by `mul.rn.bf16x2`: the exact product of
//   two bf16 values fits a float, so that is the same rounding), plus the
//   bias where the ConvBlock has no BN (explicit _rn intrinsics, no FMA
//   contraction: bit for bit); then the ConvBlock's eval BN of that
//   T-rounded value and its ReLU where the block has one, rounded once to
//   T. The BN is PyTorch's own on the card, op for op: weight * (v - mean)
//   * rsqrtf(var + eps) + bias in f32, the last product and sum one fma (its
//   CUDA kernel's expression as nvcc contracts it, for bf16 and f32, NCHW
//   and channels_last alike; cuDNN's, which PyTorch takes for f32 in
//   channels_last, rounds differently). So the fused block equals
//   F.batch_norm on a contiguous NCHW tensor bit for bit.

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using adam::Vec8;
using adam::to_float;
using namespace adam::wg;

// float(1 / 127.5), the factor XLA's jit puts in place of AQT's division.
constexpr float kRecipBound = 0x1.0101020000000p-7f;
constexpr float kClip = 127.0f;

// Rounding and conversion on the integer and f32 pipes: a type conversion
// instruction issues at a quarter of their rate on Hopper, and the epilogues
// round every element several times.
//
// v rounded to T (to nearest, even), as a float: bf16 by its bits (finite v).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  const unsigned u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// float(acc) rounded to nearest: the two 16-bit halves exact in f32 (the
// magic-number trick), then one fma rounds hi * 2^16 + lo once.
__device__ __forceinline__ float int_to_float(int acc) {
  const float lo = __uint_as_float(0x4b000000u | (acc & 0xffff)) - 8388608.f;
  const float hi = __int_as_float(0x4b400000 + (acc >> 16)) - 12582912.f;
  return __fmaf_rn(hi, 65536.f, lo);
}

// round_half_even(p) for |p| <= 127 (the magic-number trick).
__device__ __forceinline__ int round_small(float p) {
  return __float_as_int(__fadd_rn(p, 12582912.f)) - 0x4b400000;
}

// ---------------------------------------------------------------- Q1

constexpr int kQThreads = 512;
// The most images of a group: the per-image maxima and scales that a block
// keeps in shared memory.
constexpr int kQMaxGroup = 64;

struct QuantArgs {
  const void* x;
  unsigned* amax;      // (N) abs-max bits, zeroed
  unsigned* arrived;   // (groups) blocks arrived, zeroed
  int8_t* q;
  float* scale;
  int N, HW, C, cin_pad;
};

template <typename T>
__device__ __forceinline__ void image_scale(unsigned bits, float& scale, float& inv) {
  float a = __uint_as_float(bits);
  if (a == 0.f) a = 1.f;
  scale = round_to<T>(__fmul_rn(a, kRecipBound));
  inv = round_to<T>(__fdiv_rn(1.f, scale));
  if (isinf(inv)) inv = 1.f;
}

template <typename T>
__device__ __forceinline__ int quantize_one(float v, float inv) {
  const float p = round_to<T>(__fmul_rn(v, inv));
  return round_small(fminf(fmaxf(p, -kClip), kClip));
}

// Two bf16 values packed (the first in the low half), multiplied by two
// others and rounded once to bf16 each: the exact product of two bf16
// values fits a float, so this is round_to<bf16>(a * b) twice.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Eight values of x as loaded (16 bytes of bf16, 32 of f32), their abs-max
// and their quantized bytes. In bf16 two values at once: the abs by a mask,
// the maximum, the product by the image's 1 / scale (the exact product of
// two bf16 values fits a float, so `mul.rn.bf16x2` rounds it as
// round_to<bf16>(x * inv) does) and the clip, by bf16x2 instructions.
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
};
template <> struct Raw8<float> {
  float v[8];
  __device__ __forceinline__ void load(const float* p) { Vec8<float>::load(p, v); }
};

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t min_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float absmax8(const Raw8<float>& r) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(r.v[k]));
  return m;
}
__device__ __forceinline__ float absmax8(const Raw8<__nv_bfloat16>& r) {
  constexpr uint32_t kAbs = 0x7fff7fffu;
  const uint32_t m = max_bf16x2(max_bf16x2(r.u.x & kAbs, r.u.y & kAbs),
                                max_bf16x2(r.u.z & kAbs, r.u.w & kAbs));
  return fmaxf(__uint_as_float(m << 16), __uint_as_float(m & 0xffff0000u));
}

__device__ __forceinline__ uint2 quantize8(const Raw8<float>& r, float inv) {
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k / 4] |= (static_cast<unsigned>(quantize_one<float>(r.v[k], inv)) & 0xffu) << (8 * (k % 4));
  return make_uint2(w[0], w[1]);
}
__device__ __forceinline__ uint2 quantize8(const Raw8<__nv_bfloat16>& r, float inv) {
  const uint32_t inv2 = (__float_as_uint(inv) >> 16) * 0x10001u;
  const uint32_t in[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // bf16 -127 and 127 in both halves.
    const uint32_t p = min_bf16x2(max_bf16x2(mul_bf16x2(in[k], inv2), 0xc2fec2feu), 0x42fe42feu);
    const unsigned lo = static_cast<unsigned>(round_small(__uint_as_float(p << 16))) & 0xffu;
    const unsigned hi =
        static_cast<unsigned>(round_small(__uint_as_float(p & 0xffff0000u))) & 0xffu;
    w[k / 2] |= (lo | hi << 8) << (16 * (k % 2));
  }
  return make_uint2(w[0], w[1]);
}

// One item's abs-max: 8 channels of a pixel (vec8), else one value.
template <typename T>
__device__ __forceinline__ float item_absmax(const T* x, long long i, bool vec8) {
  if (!vec8) return fabsf(to_float(x[i]));
  Raw8<T> r;
  r.load(x + i * 8);
  return absmax8(r);
}

// The abs-max of the images [n0, n1), walked as one flat range of items
// (four loads in flight a thread): each thread's running maximum goes to
// the block's per-image maximum in shared memory when its items cross into
// the next image, and the block's maxima to the images' global ones once.
template <typename T>
__device__ void absmax_group(const QuantArgs& a, int n0, int n1, unsigned* smax) {
  const bool vec8 = a.C % 8 == 0;
  const int per = a.HW * a.C / (vec8 ? 8 : 1);
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(n0) * a.HW * a.C;
  const int items = per * (n1 - n0);
  const int step = gridDim.x * kQThreads;
  if (threadIdx.x < n1 - n0) smax[threadIdx.x] = 0u;
  __syncthreads();
  int i = blockIdx.x * kQThreads + threadIdx.x;
  int img = i / per;
  int next = (img + 1) * per;
  float m = 0.f;
  while (i < items) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = i + u * step < items ? item_absmax(x, i + u * step, vec8) : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u, i += step) {
      if (i >= items) break;
      if (i >= next) {
        atomicMax(smax + img, __float_as_uint(m));
        m = 0.f;
        img = i / per;
        next = (img + 1) * per;
      }
      m = fmaxf(m, v[u]);
    }
  }
  if (img < n1 - n0) atomicMax(smax + img, __float_as_uint(m));
  __syncthreads();
  if (threadIdx.x < n1 - n0 && smax[threadIdx.x] != 0u)
    atomicMax(a.amax + n0 + threadIdx.x, smax[threadIdx.x]);
}

// One item of the quantizing pass: 8 padded channels of a pixel (C % 8 ==
// 0; its values loaded in r), else a pixel (the few-channel input of a
// first conv). `item` counts from image n0 of x and q.
template <typename T>
__device__ __forceinline__ void quantize_item(const QuantArgs& a, const T* x, int8_t* q,
                                              int item, const Raw8<T>& r, float inv,
                                              bool vec8) {
  if (vec8) {
    const int chunks = a.cin_pad / 8;
    const long long p = item / chunks;
    const int c0 = (item - static_cast<int>(p) * chunks) * 8;
    *reinterpret_cast<uint2*>(q + p * a.cin_pad + c0) =
        c0 < a.C ? quantize8(r, inv) : make_uint2(0u, 0u);
  } else if (a.cin_pad == 4) {
    unsigned w = 0u;
    for (int c = 0; c < a.C; ++c)
      w |= (static_cast<unsigned>(quantize_one<T>(to_float(x[item * a.C + c]), inv)) & 0xffu)
           << (8 * c);
    *reinterpret_cast<unsigned*>(q + static_cast<long long>(item) * 4) = w;
  } else {
    for (int c = 0; c < a.cin_pad; ++c)
      q[static_cast<long long>(item) * a.cin_pad + c] =
          c < a.C ? static_cast<int8_t>(quantize_one<T>(to_float(x[item * a.C + c]), inv)) : 0;
  }
}

// Quantize the images [n0, n1) as one flat range of items, each thread's
// in reverse (the newest bytes in L2 first), two loads in flight a thread.
// The images' scales are taken once a block.
template <typename T>
__device__ void quantize_group(const QuantArgs& a, int n0, int n1, float* sinv) {
  if (threadIdx.x < n1 - n0) {
    float scale, inv;
    image_scale<T>(__ldcg(a.amax + n0 + threadIdx.x), scale, inv);   // L2: the atomics' value
    sinv[threadIdx.x] = inv;
    if (blockIdx.x == 0) a.scale[n0 + threadIdx.x] = scale;
  }
  __syncthreads();
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(n0) * a.HW * a.C;
  int8_t* q = a.q + static_cast<long long>(n0) * a.HW * a.cin_pad;
  const bool vec8 = a.C % 8 == 0;
  const int chunks = vec8 ? a.cin_pad / 8 : 1;
  const int per = a.HW * chunks;
  const int items = per * (n1 - n0);
  const int step = gridDim.x * kQThreads;
  const int first = blockIdx.x * kQThreads + threadIdx.x;
  if (first >= items) return;
  for (int item = first + (items - 1 - first) / step * step; item >= 0; item -= 2 * step) {
    Raw8<T> r[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = item - u * step;
      const long long p = it / chunks;
      const int c0 = (it - static_cast<int>(p) * chunks) * 8;
      if (vec8 && it >= 0 && c0 < a.C) r[u].load(x + p * a.C + c0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = item - u * step;
      if (it >= 0) quantize_item<T>(a, x, q, it, r[u], sinv[it / per], vec8);
    }
  }
}

__device__ __forceinline__ void arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

__device__ __forceinline__ void wait_all(unsigned* counter) {
  if (threadIdx.x == 0) {
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < gridDim.x);
  }
  __syncthreads();
}

// Step s: the abs-max of group s, the arrival on its counter, then the wait
// on group s - 1's (every block arrived a step before, so it rarely stalls)
// and the quantizing of group s - 1.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const QuantArgs a) {
  __shared__ unsigned smax[kQMaxGroup];
  __shared__ float sinv[kQMaxGroup];
  const int groups = (a.N + kQMaxGroup - 1) / kQMaxGroup;
  for (int s = 0; s <= groups; ++s) {
    if (s < groups) {
      absmax_group<T>(a, s * kQMaxGroup, min((s + 1) * kQMaxGroup, a.N), smax);
      arrive(a.arrived + s);
    }
    if (s > 0) {
      wait_all(a.arrived + s - 1);
      quantize_group<T>(a, (s - 1) * kQMaxGroup, min(s * kQMaxGroup, a.N), sinv);
    }
  }
}

template <typename T>
int launch_quantize(const void* x, void* scratch, void* q, void* scale, int N, int HW, int C,
                    int cin_pad, cudaStream_t s) {
  const int groups = (N + kQMaxGroup - 1) / kQMaxGroup;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (N + groups), s);
  if (err != cudaSuccess) return err;
  // Resident blocks only (the counters wait for every block): as many as
  // the SMs hold, no more than an image's items need. The device's limit is
  // read once a device.
  static int known_dev = -1, resident = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != known_dev) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_kernel<T>, kQThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    known_dev = dev;
    resident = sms * per_sm;
  }
  const long long items = static_cast<long long>(HW) * (C % 8 == 0 ? cin_pad / 8 : 1);
  long long blocks = resident;
  const long long need = (items + kQThreads - 1) / kQThreads;
  blocks = blocks < need ? blocks : need;
  QuantArgs args{x, static_cast<unsigned*>(scratch), static_cast<unsigned*>(scratch) + N,
                 static_cast<int8_t*>(q), static_cast<float*>(scale), N, HW, C, cin_pad};
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(quantize_kernel<T>),
                                     dim3(static_cast<unsigned>(blocks)), dim3(kQThreads),
                                     params, 0, s);
}

// Q1's two passes as launches of their own (int8_absmax, int8_quantize_at):
// the same group walks, each group's shared values rewritten only after
// every thread is done with the last group's.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
absmax_kernel(const QuantArgs a) {
  __shared__ unsigned smax[kQMaxGroup];
  for (int n0 = 0; n0 < a.N; n0 += kQMaxGroup) {
    absmax_group<T>(a, n0, min(n0 + kQMaxGroup, a.N), smax);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_at_kernel(const QuantArgs a) {
  __shared__ float sinv[kQMaxGroup];
  for (int n0 = 0; n0 < a.N; n0 += kQMaxGroup) {
    quantize_group<T>(a, n0, min(n0 + kQMaxGroup, a.N), sinv);
    __syncthreads();
  }
}

// A launch of one of the two passes: blocks as an image's items need, at
// most as many as the SMs hold at once.
template <typename Kernel>
int launch_pass(Kernel kernel, const QuantArgs& args, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kQThreads, 0)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const long long items =
      static_cast<long long>(args.HW) * (args.C % 8 == 0 ? args.cin_pad / 8 : 1);
  const long long need = (items + kQThreads - 1) / kQThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(need < resident ? need : resident), kQThreads, 0, s>>>(args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- Q2 epilogue

// The epilogue's per-channel parameters.
struct Epilogue {
  const float* sx;     // (N) the images' scales
  const float* sw;     // (cout) the channels' scales
  const float* bias;   // (cout) or null
  const float* bn;     // (4, cout) weight, bias, mean, var + eps of the eval BN
                       // (eval_bn_stats), or null
  int cout, relu;
};

// A float that holds a value of T, as a T.
template <typename T> __device__ __forceinline__ T exact(float v);
template <> __device__ __forceinline__ float exact<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 exact<__nv_bfloat16>(float v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(v) >> 16));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return __float_as_uint(lo) >> 16 | (__float_as_uint(hi) & 0xffff0000u);
}

// An output channel's epilogue parameters, loaded once a thread: the
// channel's scale (a value of T), its bias, and its eval BN's weight, bias,
// mean and rsqrtf(var + eps), as PyTorch's CUDA BN kernel takes them.
struct Channel {
  float sw, bias;
  float w, b, mean, inv;
};

// The eval BN of v (a value of T) and the ReLU, in f32 as PyTorch's CUDA BN
// kernel rounds it: weight * (v - mean) * inv + bias, its last product and
// sum one fma.
__device__ __forceinline__ float bn_relu(const Channel& c, float v, bool relu) {
  const float y = __fmaf_rn(__fmul_rn(c.w, __fsub_rn(v, c.mean)), c.inv, c.b);
  return relu && !(y > 0.f) ? 0.f : y;
}

// Two output elements of neighbouring channels from their int32 sums, as
// values of T: AQT's dequant, each step rounded to T (bf16: the two
// products by the packed bf16x2 multiply), plus the bias where there is no
// BN; then the eval BN of that value and the ReLU (bn_relu), rounded once
// to T.
template <typename T>
__device__ __forceinline__ void dequant_bn_relu2(const Epilogue& e, const Channel& c0,
                                                 const Channel& c1, int a0, int a1,
                                                 float xs, float& o0, float& o1) {
  float v0 = round_to<T>(int_to_float(a0)), v1 = round_to<T>(int_to_float(a1));
  if constexpr (sizeof(T) == 2) {
    const uint32_t xs2 = (__float_as_uint(xs) >> 16) * 0x10001u;
    const uint32_t v = mul_bf16x2(mul_bf16x2(pack_bf16x2(v0, v1), xs2),
                                  pack_bf16x2(c0.sw, c1.sw));   // the channels' scales
    v0 = __uint_as_float(v << 16);
    v1 = __uint_as_float(v & 0xffff0000u);
  } else {
    v0 = __fmul_rn(__fmul_rn(v0, xs), c0.sw);
    v1 = __fmul_rn(__fmul_rn(v1, xs), c1.sw);
  }
  if (e.bias != nullptr) {
    v0 = round_to<T>(__fadd_rn(v0, c0.bias));
    v1 = round_to<T>(__fadd_rn(v1, c1.bias));
  }
  if (e.bn != nullptr) {
    v0 = round_to<T>(bn_relu(c0, v0, e.relu));
    v1 = round_to<T>(bn_relu(c1, v1, e.relu));
  } else if (e.relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  o0 = v0;
  o1 = v1;
}

// The epilogue of a block's output tile, whose int32 sums the block has put
// in shared memory (rows x cols, `ld` ints a row). Thread t takes the
// channel octet t % (cols / 8) of rows t / (cols / 8), then every
// `threads / (cols / 8)` rows after it, so that a warp stores whole runs of
// a pixel's channels, 16 bytes (bf16) or 32 bytes (f32) a thread, and a
// thread's channel parameters stay in registers. `where(r, xs)` gives row
// r's output offset in elements (negative: outside the output) and its
// image's scale. `cols` is a multiple of 8; channels at or beyond `e.cout`
// are not stored.
template <typename T, int kThreadsE, typename Where>
__device__ __forceinline__ void store_sums(const int* sums, int ld, int rows, int cols, int co0,
                                           const Epilogue& e, T* out, Where where) {
  const int octets = cols / 8;
  const int step = kThreadsE / octets;
  const int o = threadIdx.x % octets;
  int r = threadIdx.x / octets;
  if (r >= step) return;
  const int c0 = co0 + 8 * o;
  const int valid = min(8, e.cout - c0);
  if (valid <= 0) return;
  Channel ch[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int co = min(c0 + k, e.cout - 1);
    ch[k].sw = e.sw[co];
    ch[k].bias = e.bias != nullptr ? e.bias[co] : 0.f;
    if (e.bn != nullptr) {
      ch[k].w = e.bn[co];
      ch[k].b = e.bn[e.cout + co];
      ch[k].mean = e.bn[2 * e.cout + co];
      ch[k].inv = rsqrtf(e.bn[3 * e.cout + co]);
    }
  }
  const bool vec = valid == 8 && e.cout % 8 == 0;
  // Four rows a thread at a time: 32 independent elements to hide the
  // latency of a block's few warps.
  constexpr int kRows = 4;
#pragma unroll 1
  for (; r < rows; r += kRows * step) {
    int acc[kRows][8];
    long long off[kRows];
    float xs[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int ru = r + u * step;
      off[u] = ru < rows ? where(ru, xs[u]) : -1;
      if (off[u] < 0) continue;
      const int4 lo = *reinterpret_cast<const int4*>(sums + ru * ld + 8 * o);
      const int4 hi = *reinterpret_cast<const int4*>(sums + ru * ld + 8 * o + 4);
      acc[u][0] = lo.x; acc[u][1] = lo.y; acc[u][2] = lo.z; acc[u][3] = lo.w;
      acc[u][4] = hi.x; acc[u][5] = hi.y; acc[u][6] = hi.z; acc[u][7] = hi.w;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (off[u] < 0) continue;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; k += 2)
        dequant_bn_relu2<T>(e, ch[k], ch[k + 1], acc[u][k], acc[u][k + 1], xs[u], v[k],
                            v[k + 1]);
      T* dst = out + off[u] + c0;
      if (vec) {
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          // The values are bf16 already: their high halves, packed.
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = __float_as_uint(v[2 * k]) >> 16 | (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < valid) dst[k] = exact<T>(v[k]);
      }
    }
  }
}

// ---------------------------------------------------------------- Q2 gather body

constexpr int kBM = 128;          // output pixels a block
constexpr int kBN = 64;           // output channels a block (the packing's cout tile)
constexpr int kBK = 64;           // K bytes a stage: two m16n8k32 steps
constexpr int kRow = kBK + 16;    // 80 bytes: conflict-free fragment loads
constexpr int kStages = 3;
constexpr int kThreads = 256;

struct GatherArgs {
  const int8_t* q;
  const int8_t* w;
  void* out;
  long long M;
  int H, W, cin_pad, Ho, Wo, k_pad, kh, kw, stride, pad;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVec: bytes a copy of the A gather (16, or 4 when cin_pad is 4).
template <int kVec, typename T>
__global__ void __launch_bounds__(kThreads)
int8_conv_gather_kernel(const GatherArgs a, const Epilogue e) {
  constexpr int kCols = kBK / kVec;                 // copies a row of A
  constexpr int kRowStep = kThreads / kCols;        // rows between a thread's copies
  constexpr int kRowsPer = kBM / kRowStep;          // A copies a thread
  // The ring; after the K walk, the block's int32 sums (kBM x kSumLd).
  constexpr int kSumLd = kBN + 8;
  static_assert(kBM * kSumLd * 4 <= kStages * (kBM + kBN) * kRow, "the sums fit the ring");
  __shared__ __align__(16) int8_t ring[kStages * (kBM + kBN) * kRow];
  int8_t (*sA)[kBM * kRow] = reinterpret_cast<int8_t (*)[kBM * kRow]>(ring);
  int8_t (*sB)[kBN * kRow] = reinterpret_cast<int8_t (*)[kBN * kRow]>(ring + kStages * kBM * kRow);

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int taps = a.kh * a.kw;
  const int hw_out = a.Ho * a.Wo;

  // The output pixels of this thread's A rows.
  const int col = tid % kCols;
  long long img_off[kRowsPer];
  int iy0[kRowsPer], ix0[kRowsPer];
  bool row_ok[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const long long m = m0 + tid / kCols + i * kRowStep;
    row_ok[i] = m < a.M;
    const long long mm = row_ok[i] ? m : 0;
    const int n = static_cast<int>(mm / hw_out);
    const int r = static_cast<int>(mm - static_cast<long long>(n) * hw_out);
    const int oy = r / a.Wo, ox = r - (r / a.Wo) * a.Wo;
    img_off[i] = static_cast<long long>(n) * a.H * a.W * a.cin_pad;
    iy0[i] = oy * a.stride - a.pad;
    ix0[i] = ox * a.stride - a.pad;
  }

  auto load_stage = [&](int stage, int kt) {
    // A: the gathered input, zero outside the image and beyond the taps.
    const int k = kt * kBK + col * kVec;
    const int tap = k / a.cin_pad;
    const int ci = k - tap * a.cin_pad;
    const int ky = tap / a.kw, kx = tap - (tap / a.kw) * a.kw;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      const bool ok = row_ok[i] && tap < taps && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const int8_t* src =
          ok ? a.q + img_off[i] + (static_cast<long long>(iy) * a.W + ix) * a.cin_pad + ci : a.q;
      const uint32_t dst = static_cast<uint32_t>(
          __cvta_generic_to_shared(&sA[stage][(tid / kCols + i * kRowStep) * kRow + col * kVec]));
      if constexpr (kVec == 16) cp_async16(dst, src, ok ? 16 : 0);
      else cp_async4(dst, src, ok ? 4 : 0);
    }
    // B: the packed weights, one 16-byte copy a thread.
    const int brow = tid / (kBK / 16), bcol = tid % (kBK / 16);
    const int kb = kt * kBK + bcol * 16;
    const bool okb = kb < a.k_pad;
    const int8_t* srcb = okb ? a.w + static_cast<long long>(n0 + brow) * a.k_pad + kb : a.w;
    const uint32_t dstb = static_cast<uint32_t>(
        __cvta_generic_to_shared(&sB[stage][brow * kRow + bcol * 16]));
    cp_async16(dstb, srcb, okb ? 16 : 0);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mi][ni][k] = 0;

  const int KT = (a.k_pad + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* A = sA[kt % kStages];
    const int8_t* B = sB[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      if (kt * kBK + kk >= a.k_pad) break;    // k_pad is a multiple of 32
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = A + (wm * 32 + mi * 16 + g) * kRow + kk + t * 4;
        const int8_t* r1 = r0 + 8 * kRow;
        af[mi][0] = *reinterpret_cast<const unsigned*>(r0);
        af[mi][1] = *reinterpret_cast<const unsigned*>(r1);
        af[mi][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(r1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* r = B + (wn * 32 + ni * 8 + g) * kRow + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(r);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(r + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: the sums through shared memory (each thread's pairs as 8
  // bytes), then `store_sums`.
  __syncthreads();
  int* sums = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<int2*>(sums + (wm * 32 + mi * 16 + g + 8 * h) * kSumLd + wn * 32 +
                                 ni * 8 + t * 2) =
            make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  __syncthreads();
  store_sums<T, kThreads>(sums, kSumLd, kBM, kBN, n0, e, static_cast<T*>(a.out),
                          [&](int r, float& xs) -> long long {
                            const long long m = m0 + r;
                            if (m >= a.M) return -1;
                            xs = e.sx[m / hw_out];      // the image's scale
                            return m * e.cout;
                          });
}

// ---------------------------------------------------------------- Q2 tile body

constexpr int kTile = 16;            // 16x16 output positions: four 8x8 patches
constexpr int kStageC = 32;          // input channels a stage: one k32 step a tap
constexpr int kTileThreads = 256;    // two warpgroups, each two m64 patches
constexpr int kBarrierBytes = 128;   // one mbarrier a slot, ahead of the slots
// Shared memory a block may take so that two fit an SM (228 KB, 1 KB of it
// reserved a block).
constexpr size_t kTwoBlockSmem = (233472 - 2 * 1024) / 2;

// The staged input of a stage: [16-channel group (2)][plane (subs)][plane
// pixel][16 bytes]. KS 3 (3x3, stride 1, pad 1): one plane, the 18x18 tile.
// KS 4 (4x4, stride 2, pad 1): the two 17x17 column-parity planes of one row
// parity. A group's planes are padded so that the group stride is 2 mod 8
// in 16-byte units: the two groups of neighbouring pixels fall into
// different bank groups.
template <int KS> struct TileShape;

template <> struct TileShape<3> {
  static constexpr int tw = kTile + 2;
  static constexpr int subs = 1;
  static constexpr int phases = 1;       // stages a 32-channel group
  static constexpr int taps = 9;         // taps a stage
  static constexpr int pix = tw * tw;
  static constexpr int plane = ((pix + 5) / 8) * 8 + 2;
  static constexpr int a_bytes = 2 * subs * plane * 16;
  // Tap i = 3 ky + kx reads the tile at (y + ky, x + kx).
  static __device__ __forceinline__ int tap_offset(int i) { return (i / 3) * tw + i % 3; }
};

template <> struct TileShape<4> {
  static constexpr int tw = kTile + 1;
  static constexpr int subs = 2;
  static constexpr int phases = 2;
  static constexpr int taps = 8;
  static constexpr int pix = tw * tw;
  static constexpr int plane = ((pix + 2) / 4) * 4 + 1;
  static constexpr int a_bytes = 2 * subs * plane * 16;
  // Tap i = 4 a + kx of row parity py (ky = 2 a + py) reads column-parity
  // plane kx % 2 at (y + a, x + kx / 2).
  static __device__ __forceinline__ int tap_offset(int i) {
    return ((i & 3) & 1) * plane + (i >> 2) * tw + ((i & 3) >> 1);
  }
};

constexpr size_t tile_smem_bytes(int n, int ks, int slots) {
  return kBarrierBytes +
         size_t(slots) * ((ks == 3 ? TileShape<3>::a_bytes : TileShape<4>::a_bytes) +
                          (ks == 3 ? 9 : 8) * kStageC * n);
}
// The plan: two blocks an SM, so that one block's epilogue and ring fill
// run under the other's products: three slots, or four where four fit two
// (the chunks the body is built for all fit three: tile_chunk_ok).
constexpr bool tile_two_blocks(int n, int ks) {
  return n <= 96 && tile_smem_bytes(n, ks, 3) <= kTwoBlockSmem;
}
constexpr int tile_slots(int n, int ks) {
  return tile_two_blocks(n, ks) && tile_smem_bytes(n, ks, 4) > kTwoBlockSmem ? 3 : 4;
}
constexpr size_t tile_plan_smem(int n, int ks) {
  return tile_smem_bytes(n, ks, tile_slots(n, ks));
}
static_assert(tile_two_blocks(96, 3) && tile_two_blocks(64, 4), "every chunk runs two blocks");

struct TileArgs {
  const int8_t* q;   // (N, H, W, cin_pad)
  const int8_t* w;   // (cout / N, stages, taps * 32 * N) packed slabs
  void* out;         // (N, Ho, Wo, cout)
  int H, W, cin_pad, Ho, Wo;
};

template <int N, int KS, int kSlots, typename T>
__global__ void __launch_bounds__(kTileThreads, tile_two_blocks(N, KS) ? 2 : 1)
int8_conv_tile_kernel(const TileArgs a, const Epilogue e) {
  using S = TileShape<KS>;
  constexpr int kBBytes = S::taps * kStageC * N;
  constexpr int kStage = S::a_bytes + kBBytes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t mbar0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t smem0 = mbar0 + kBarrierBytes;
  const int tid = threadIdx.x;

  // Block -> (tile, output chunk), the chunk fastest: neighbouring blocks
  // read the same input tile while it is in L2.
  int bx = blockIdx.x;
  const int n_co = e.cout / N;
  const int chunk = bx % n_co;
  bx /= n_co;
  const int tiles_x = (a.Wo + kTile - 1) / kTile;
  const int tx0 = (bx % tiles_x) * kTile;
  const int ty0 = (bx / tiles_x) * kTile;
  const int n = blockIdx.y;
  // The input pixel that tile pixel (0, 0) of the first plane stands for.
  const int iy0 = (KS == 3 ? ty0 : 2 * ty0) - 1;
  const int ix0 = (KS == 3 ? tx0 : 2 * tx0) - 1;
  const int n_stages = a.cin_pad / kStageC * S::phases;
  const int8_t* img = a.q + static_cast<size_t>(n) * a.H * a.W * a.cin_pad;
  const int8_t* slabs = a.w + static_cast<size_t>(chunk) * n_stages * kBBytes;

  // Stage j: channel group j / phases, row parity j % phases. Its weights
  // by one bulk copy of one thread; its planes by cp.async, 16 bytes a
  // thread, the two groups of a pixel from 32 contiguous bytes.
  auto load = [&](int j) {
    const int cc = (j / S::phases) * kStageC;
    const int py = j % S::phases;
    const uint32_t sA = smem0 + (j % kSlots) * kStage;
    if (tid == 0)
      bulk_copy(sA + S::a_bytes, slabs + static_cast<size_t>(j) * kBBytes, kBBytes,
                mbar0 + (j % kSlots) * 8);
#pragma unroll
    for (int i = tid; i < 2 * S::subs * S::pix; i += kTileThreads) {
      const int g = i & 1, rest = i >> 1;
      const int s = rest / S::pix, p = rest - (rest / S::pix) * S::pix;
      const int ty = p / S::tw, tx = p - (p / S::tw) * S::tw;
      const int yy = KS == 3 ? iy0 + ty : iy0 + 2 * ty + py;
      const int xx = KS == 3 ? ix0 + tx : ix0 + 2 * tx + s;
      const bool ok = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
      const int8_t* src =
          ok ? img + (static_cast<size_t>(yy) * a.W + xx) * a.cin_pad + cc + g * 16 : a.q;
      cp_async16(sA + ((g * S::subs + s) * S::plane + p) * 16, src, ok ? 16 : 0);
    }
  };

  // Warpgroup g owns tile rows 8g..8g+7: patch m is columns 8m..8m+7. Row r
  // of an m64 is patch pixel (r / 8, r % 8), so a tap is a start offset.
  const int wg = tid / 128;
  int acc[2][N / 2];
  uint64_t da0[2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
    da0[m] = wg_desc(smem0 + ((8 * wg) * S::tw + 8 * m) * 16, S::subs * S::plane * 16,
                     S::tw * 16);
  const uint64_t db0 = wg_desc(smem0 + S::a_bytes, (N / 8) * 128, 128);

  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(mbar0 + j * 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSlots - 2; ++j) {
    if (j < n_stages) load(j);
    cp_async_commit();
  }
  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kSlots - 3>();   // stage `it` has landed (this thread's part)
    mbar_wait(mbar0 + (it % kSlots) * 8, (it / kSlots) & 1);   // ... and its weights
    fence_proxy_async();
    __syncthreads();                  // ... everyone's; and slot it-2 is drained
    if (it + kSlots - 2 < n_stages) load(it + kSlots - 2);
    cp_async_commit();
    const uint64_t slot = static_cast<uint64_t>(((it % kSlots) * kStage) >> 4);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < S::taps; ++tap) {
      const uint64_t db = db0 + slot + ((tap * kStageC * N) >> 4);
      const uint64_t atap = slot + S::tap_offset(tap);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wgmma_s8<N>(acc[m], da0[m] + atap, db, tap == 0 ? it > 0 : 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // the stage before this one is drained
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(acc[m][i]) :: "memory");

  // Epilogue: the sums through shared memory (the ring is drained), then
  // `store_sums`. Thread (warp w, lane) holds rows 16w + lane / 4 (+ 8) and
  // columns 8j + 2 (lane % 4) (+ 1) of each m64: tile position (8 wg + 2w +
  // h, 8m + lane / 4); its pairs go in as 8 bytes (rows N + 8 ints apart:
  // conflict-free).
  constexpr int kSumLd = N + 8;
  static_assert(kTile * kTile * kSumLd * 4 <= kSlots * kStage, "the sums fit the ring");
  cp_async_wait<0>();
  __syncthreads();
  int* sums = reinterpret_cast<int*>(smem_raw + kBarrierBytes);
  const int lane = tid & 31, w = (tid >> 5) & 3, qd = lane >> 2, l = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<int2*>(sums + ((8 * wg + 2 * w + h) * kTile + 8 * m + qd) * kSumLd +
                                 8 * j + 2 * l) =
            make_int2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
  __syncthreads();
  const float xs = e.sx[n];
  store_sums<T, kTileThreads>(sums, kSumLd, kTile * kTile, N, chunk * N, e,
                              static_cast<T*>(a.out),
                              [&](int r, float& scale) -> long long {
                                const int y = ty0 + r / kTile, x = tx0 + r % kTile;
                                if (y >= a.Ho || x >= a.Wo) return -1;
                                scale = xs;
                                return ((static_cast<long long>(n) * a.Ho + y) * a.Wo + x) *
                                       e.cout;
                              });
}

template <int N, int KS, typename T>
int launch_tile(const TileArgs& a, const Epilogue& e, int batch, cudaStream_t s) {
  constexpr size_t smem = tile_plan_smem(N, KS);
  auto kernel = int8_conv_tile_kernel<N, KS, tile_slots(N, KS), T>;
  cudaError_t err = adam::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.Ho + kTile - 1) / kTile) * ((a.Wo + kTile - 1) / kTile);
  kernel<<<dim3(tiles * (e.cout / N), batch), kTileThreads, smem, s>>>(a, e);
  return cudaGetLastError();
}

template <int N, typename T>
int launch_tile_n(const TileArgs& a, const Epilogue& e, int ks, int batch, cudaStream_t s) {
  return ks == 3 ? launch_tile<N, 3, T>(a, e, batch, s) : launch_tile<N, 4, T>(a, e, batch, s);
}

template <typename T>
int launch_tile_t(const TileArgs& a, const Epilogue& e, int n_chunk, int ks, int batch,
                  cudaStream_t s) {
  switch (n_chunk) {
    case 96: return launch_tile<96, 3, T>(a, e, batch, s);
    case 64: return launch_tile_n<64, T>(a, e, ks, batch, s);
    case 48: return launch_tile_n<48, T>(a, e, ks, batch, s);
    case 32: return launch_tile_n<32, T>(a, e, ks, batch, s);
    default: return launch_tile_n<16, T>(a, e, ks, batch, s);
  }
}

template <typename T>
int launch_gather(const GatherArgs& a, const Epilogue& e, int cout_pad, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.M + kBM - 1) / kBM), cout_pad / kBN);
  if (a.cin_pad % 16 == 0)
    int8_conv_gather_kernel<16, T><<<grid, kThreads, 0, s>>>(a, e);
  else
    int8_conv_gather_kernel<4, T><<<grid, kThreads, 0, s>>>(a, e);
  return cudaGetLastError();
}

// Q1's shapes: cin_pad a multiple of 4, at least C, a multiple of 8 when C
// is; the items counted in 32 bits.
bool quantize_shape_ok(int N, int HW, int C, int cin_pad) {
  return N >= 1 && HW >= 1 && C >= 1 && cin_pad >= C && cin_pad % 4 == 0 &&
         (C % 8 != 0 || cin_pad % 8 == 0) &&
         static_cast<long long>(N) * HW * (C > cin_pad ? C : cin_pad) < (1ll << 31);
}

// The chunks the tile body is built for: 96 at 3x3 only (two blocks an SM);
// at 4x4 stride 2 a 96-wide chunk would run one.
bool tile_chunk_ok(int n, int ks) {
  return (n == 96 && ks == 3) || n == 64 || n == 48 || n == 32 || n == 16;
}

}  // namespace

// Q1. x (N, H*W, C) in T (is_bf16), scratch (2N,) int32; writes
// q (N, H*W, cin_pad) int8 and scale (N,) f32. cin_pad: a multiple of 4, at
// least C; a multiple of 8 when C is.
extern "C" int int8_quantize(const void* x, void* scratch, void* q, void* scale, int N, int HW,
                             int C, int cin_pad, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!quantize_shape_ok(N, HW, C, cin_pad)) return cudaErrorInvalidValue;
  return is_bf16 ? launch_quantize<__nv_bfloat16>(x, scratch, q, scale, N, HW, C, cin_pad, s)
                 : launch_quantize<float>(x, scratch, q, scale, N, HW, C, cin_pad, s);
}

// Q1's first pass alone. x (N, H*W, C) in T (is_bf16); writes amax (N,) f32,
// the abs-max of each image's values in x (0 for an all-zero image).
extern "C" int int8_absmax(const void* x, void* amax, int N, int HW, int C, int is_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || HW < 1 || C < 1 || static_cast<long long>(N) * HW * C >= (1ll << 31))
    return cudaErrorInvalidValue;   // items are counted in 32 bits
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * N, s);
  if (err != cudaSuccess) return err;
  const QuantArgs args{x, static_cast<unsigned*>(amax), nullptr, nullptr, nullptr, N, HW, C, C};
  return is_bf16 ? launch_pass(absmax_kernel<__nv_bfloat16>, args, s)
                 : launch_pass(absmax_kernel<float>, args, s);
}

// Q1's second pass alone, at a given abs-max. x (N, H*W, C) in T, amax (N,)
// f32 (the abs-max of each whole image); writes q (N, H*W, cin_pad) int8 and
// scale (N,) f32, as int8_quantize would for images of that abs-max.
extern "C" int int8_quantize_at(const void* x, const void* amax, void* q, void* scale, int N,
                                int HW, int C, int cin_pad, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!quantize_shape_ok(N, HW, C, cin_pad)) return cudaErrorInvalidValue;
  const QuantArgs args{x, static_cast<unsigned*>(const_cast<void*>(amax)), nullptr,
                       static_cast<int8_t*>(q), static_cast<float*>(scale), N, HW, C, cin_pad};
  return is_bf16 ? launch_pass(quantize_at_kernel<__nv_bfloat16>, args, s)
                 : launch_pass(quantize_at_kernel<float>, args, s);
}

// Q2. q (N, H, W, cin_pad) int8; sx (N,) and sw (cout,) f32; bias (cout,)
// f32 or null; bn (4, cout) f32 (weight, bias, mean, var + eps) or null;
// relu 0/1; writes out (N, Ho, Wo, cout) in T.
// body 1, the tile body: w packed as (cout / n_chunk, stages, taps * 32 *
//   n_chunk) slabs (ops/kernels/quant.py:pack_int8_weights); kh = kw = 3,
//   stride 1, pad 1 or kh = kw = 4, stride 2, pad 1; cin_pad a multiple of
//   32; n_chunk one of 96 (3x3 only), 64, 48, 32, 16, dividing cout.
// body 0, the gather body: w packed OHWI (cout_pad, k_pad); cin_pad 4 or a
//   multiple of 16, cout_pad a multiple of 64, k_pad a multiple of 32 and
//   at least kh * kw * cin_pad.
extern "C" int int8_conv(const void* q, const void* w, const void* sx, const void* sw,
                         const void* bias, const void* bn, int relu, void* out, int N, int H,
                         int W, int cin_pad, int Ho, int Wo, int cout, int cout_pad, int k_pad,
                         int kh, int kw, int stride, int pad, int body, int n_chunk,
                         int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue e{static_cast<const float*>(sx), static_cast<const float*>(sw),
                   static_cast<const float*>(bias), static_cast<const float*>(bn), cout,
                   relu != 0};
  if (N < 1 || Ho < 1 || Wo < 1) return cudaErrorInvalidValue;
  if (body == 1) {
    const bool shape = kh == kw && ((kh == 3 && stride == 1 && pad == 1) ||
                                    (kh == 4 && stride == 2 && pad == 1));
    if (!shape || cin_pad % kStageC != 0 || !tile_chunk_ok(n_chunk, kh) || cout % n_chunk != 0 ||
        cout_pad != cout || k_pad != kh * kw * cin_pad)
      return cudaErrorInvalidValue;
    const TileArgs a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w), out, H, W,
                     cin_pad, Ho, Wo};
    return is_bf16 ? launch_tile_t<__nv_bfloat16>(a, e, n_chunk, kh, N, s)
                   : launch_tile_t<float>(a, e, n_chunk, kh, N, s);
  }
  if (body != 0 || (cin_pad != 4 && cin_pad % 16 != 0) || cout_pad % kBN != 0 ||
      cout > cout_pad || k_pad % 32 != 0 || k_pad < kh * kw * cin_pad)
    return cudaErrorInvalidValue;
  const GatherArgs a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w), out,
                     static_cast<long long>(N) * Ho * Wo, H, W, cin_pad, Ho, Wo, k_pad, kh, kw,
                     stride, pad};
  return is_bf16 ? launch_gather<__nv_bfloat16>(a, e, cout_pad, s)
                 : launch_gather<float>(a, e, cout_pad, s);
}
