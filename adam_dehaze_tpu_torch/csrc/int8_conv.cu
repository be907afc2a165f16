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
//   Two launches: absmax_kernel (block partials of each image, then an atomic
//   max on the float's bits, which orders as the value for non-negative
//   floats) and quantize_kernel (reads x again, writes q and the scale).
//   What bounds it: memory. It reads x twice and writes a quarter (bf16: a
//   half) of it; the least traffic is one read of x and one write of q,
//   against 3.35 TB/s. The second read mostly hits the 50 MB L2 only for
//   small layers; fusing the abs-max into the producer's epilogue would
//   remove it and is left for a later redesign.
//
// Q2 (entry point int8_conv): an implicit-GEMM convolution on int8 tensor
//   cores. Rows are output pixels (M = N * Ho * Wo), columns output channels,
//   K runs over (ky, kx, ci) with ci padded to cin_pad. The weights come
//   packed once, OHWI, (cout_pad, k_pad) int8: K-major, as both operands of
//   the int8 MMA are read. A block computes a 128 x 64 tile with 8 warps
//   (4 x 2, 32 x 32 each), `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`
//   with int32 accumulators, K in steps of 64 bytes through a 3-stage
//   cp.async ring in shared memory; rows are 80 bytes apart so that the
//   fragment loads of a warp hit 32 distinct banks. The A tile is gathered
//   from q by each thread (16-byte copies of one tap's channels when cin_pad
//   is a multiple of 16, 4-byte copies when it is 4), zero-filled outside
//   the image. The epilogue is AQT's dequant: T(float(acc)), times the
//   image's scale, rounded to T, times the channel's scale, rounded to T,
//   plus the bias where the ConvBlock has no BN, and writes NHWC in T, the
//   layout the branches carry between blocks (NCHW in channels_last memory).
//   The products are exact in int32, and the epilogue rounds with explicit
//   _rn intrinsics, so the kernel equals its plain version bit for bit.
//   What bounds it: operations, 2 * M * Cout * K against 1,979 TOPS of int8
//   at the conv widths of the high branch (K >= 864); bytes (q read once, the
//   output written once) at the thin layers. mma.sync reaches a fraction of
//   the int8 rate: the wgmma (m64nNk32 s8) redesign with TMA staging is the
//   later PR's work.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using adam::Vec8;
using adam::from_float;
using adam::to_float;

// float(1 / 127.5), the factor XLA's jit puts in place of AQT's division.
constexpr float kRecipBound = 0x1.0101020000000p-7f;
constexpr float kClip = 127.0f;
constexpr int kQThreads = 256;

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------- Q1

template <typename T>
__global__ void __launch_bounds__(kQThreads)
absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax, long long per_image,
              int vec8) {
  const T* img = x + static_cast<long long>(blockIdx.y) * per_image;
  const long long step = static_cast<long long>(gridDim.x) * kQThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x;
  float m = 0.f;
  if (vec8) {
    for (long long i = first; i < per_image / 8; i += step) {
      float v[8];
      Vec8<T>::load(img + i * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(v[k]));
    }
  } else {
    for (long long i = first; i < per_image; i += step) m = fmaxf(m, fabsf(to_float(img[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[kQThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kQThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
  }
}

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
  return __float2int_rn(fminf(fmaxf(p, -kClip), kClip));
}

// One thread per 8 padded channels of a pixel (vec8: C % 8 == 0), or per
// pixel (C not a multiple of 8: the few-channel input of a first conv).
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* __restrict__ x, const unsigned* __restrict__ amax,
                int8_t* __restrict__ q, float* __restrict__ scale_out, long long pixels,
                int HW, int C, int cin_pad, int vec8) {
  const int chunks = vec8 ? cin_pad / 8 : 1;
  const long long item = static_cast<long long>(blockIdx.x) * kQThreads + threadIdx.x;
  if (item >= pixels * chunks) return;
  const long long p = item / chunks;
  const int j = static_cast<int>(item - p * chunks);
  const int n = static_cast<int>(p / HW);
  float scale, inv;
  image_scale<T>(amax[n], scale, inv);
  if (j == 0 && p == static_cast<long long>(n) * HW) scale_out[n] = scale;
  if (vec8) {
    const int c0 = j * 8;
    uint2 packed = make_uint2(0u, 0u);
    if (c0 < C) {
      float v[8];
      Vec8<T>::load(x + p * C + c0, v);
      unsigned w[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k / 4] |= (static_cast<unsigned>(quantize_one<T>(v[k], inv)) & 0xffu) << (8 * (k % 4));
      packed = make_uint2(w[0], w[1]);
    }
    *reinterpret_cast<uint2*>(q + p * cin_pad + c0) = packed;
  } else {
    for (int c = 0; c < cin_pad; ++c)
      q[p * cin_pad + c] =
          c < C ? static_cast<int8_t>(quantize_one<T>(to_float(x[p * C + c]), inv)) : 0;
  }
}

// ---------------------------------------------------------------- Q2

constexpr int kBM = 128;          // output pixels a block
constexpr int kBN = 64;           // output channels a block (the packing's cout tile)
constexpr int kBK = 64;           // K bytes a stage: two m16n8k32 steps
constexpr int kRow = kBK + 16;    // 80 bytes: conflict-free fragment loads
constexpr int kStages = 3;
constexpr int kThreads = 256;

struct ConvArgs {
  const int8_t* q;
  const int8_t* w;
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  long long M;
  int H, W, cin_pad, Ho, Wo, cout, k_pad, kh, kw, stride, pad;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
int8_conv_kernel(const ConvArgs a) {
  constexpr int kCols = kBK / kVec;                 // copies a row of A
  constexpr int kRowStep = kThreads / kCols;        // rows between a thread's copies
  constexpr int kRowsPer = kBM / kRowStep;          // A copies a thread
  __shared__ __align__(16) int8_t sA[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t sB[kStages][kBN * kRow];

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
      int8_t* dst = &sA[stage][(tid / kCols + i * kRowStep) * kRow + col * kVec];
      if constexpr (kVec == 16) cp_async16(dst, src, ok);
      else cp_async4(dst, src, ok);
    }
    // B: the packed weights, one 16-byte copy a thread.
    const int brow = tid / (kBK / 16), bcol = tid % (kBK / 16);
    const int kb = kt * kBK + bcol * 16;
    const bool okb = kb < a.k_pad;
    const int8_t* srcb = okb ? a.w + static_cast<long long>(n0 + brow) * a.k_pad + kb : a.w;
    cp_async16(&sB[stage][brow * kRow + bcol * 16], srcb, okb);
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
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

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

  // Epilogue: AQT's dequant, each step rounded to T.
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 32 + mi * 16 + g + 8 * h;
      if (m >= a.M) continue;
      const float xs = a.sx[m / hw_out];      // the image's scale
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + ni * 8 + t * 2 + e;
          if (co >= a.cout) continue;
          float v = round_to<T>(__int2float_rn(acc[mi][ni][2 * h + e]));
          v = round_to<T>(__fmul_rn(v, xs));
          v = round_to<T>(__fmul_rn(v, a.sw[co]));   // the channel's scale
          if (a.bias != nullptr) v = round_to<T>(__fadd_rn(v, a.bias[co]));
          out[m * a.cout + co] = from_float<T>(v);
        }
      }
    }
  }
}

template <typename T>
int launch_quantize(const void* x, void* amax, void* q, void* scale, int N, int HW, int C,
                    int cin_pad, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * N, s);
  if (err != cudaSuccess) return err;
  const int vec8 = C % 8 == 0;
  const long long per_image = static_cast<long long>(HW) * C;
  const long long items = vec8 ? per_image / 8 : per_image;
  // About eight blocks an SM over all images, at least one an image.
  long long blocks = (items + kQThreads - 1) / kQThreads;
  const long long cap = (8 * 132 + N - 1) / N;
  blocks = blocks < cap ? blocks : cap;
  absmax_kernel<T><<<dim3(static_cast<unsigned>(blocks), N), kQThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<unsigned*>(amax), per_image, vec8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long pixels = static_cast<long long>(N) * HW;
  const long long work = pixels * (vec8 ? cin_pad / 8 : 1);
  const unsigned qblocks = static_cast<unsigned>((work + kQThreads - 1) / kQThreads);
  quantize_kernel<T><<<qblocks, kQThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const unsigned*>(amax), static_cast<int8_t*>(q),
      static_cast<float*>(scale), pixels, HW, C, cin_pad, vec8);
  return cudaGetLastError();
}

template <typename T>
int launch_conv(const ConvArgs& args, int cout_pad, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((args.M + kBM - 1) / kBM), cout_pad / kBN);
  if (args.cin_pad % 16 == 0)
    int8_conv_kernel<16, T><<<grid, kThreads, 0, s>>>(args);
  else
    int8_conv_kernel<4, T><<<grid, kThreads, 0, s>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Q1. x (N, H*W, C) in T (is_bf16), amax (N,) int32 scratch; writes
// q (N, H*W, cin_pad) int8 and scale (N,) f32. cin_pad: a multiple of 4, at
// least C; a multiple of 8 when C is.
extern "C" int int8_quantize(const void* x, void* amax, void* q, void* scale, int N, int HW,
                             int C, int cin_pad, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin_pad < C || cin_pad % 4 != 0 || (C % 8 == 0 && cin_pad % 8 != 0))
    return cudaErrorInvalidValue;
  return is_bf16 ? launch_quantize<__nv_bfloat16>(x, amax, q, scale, N, HW, C, cin_pad, s)
                 : launch_quantize<float>(x, amax, q, scale, N, HW, C, cin_pad, s);
}

// Q2. q (N, H, W, cin_pad) int8, w (cout_pad, k_pad) int8 packed OHWI, sx (N,)
// and sw (cout,) f32, bias (cout,) f32 or null; writes out (N, Ho, Wo, cout)
// in T. cin_pad is 4 or a multiple of 16, cout_pad a multiple of 64, k_pad a
// multiple of 32 and at least kh * kw * cin_pad.
extern "C" int int8_conv(const void* q, const void* w, const void* sx, const void* sw,
                         const void* bias, void* out, int N, int H, int W, int cin_pad,
                         int Ho, int Wo, int cout, int cout_pad, int k_pad, int kh, int kw,
                         int stride, int pad, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((cin_pad != 4 && cin_pad % 16 != 0) || cout_pad % kBN != 0 || cout > cout_pad ||
      k_pad % 32 != 0 || k_pad < kh * kw * cin_pad)
    return cudaErrorInvalidValue;
  ConvArgs args{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w),
                static_cast<const float*>(sx), static_cast<const float*>(sw),
                static_cast<const float*>(bias), out,
                static_cast<long long>(N) * Ho * Wo, H, W, cin_pad, Ho, Wo, cout, k_pad,
                kh, kw, stride, pad};
  return is_bf16 ? launch_conv<__nv_bfloat16>(args, cout_pad, s)
                 : launch_conv<float>(args, cout_pad, s);
}
