// The convolution that the chain kernels share (K3 and K4 in tail_chain.cu,
// K6 through ops/kernels/conv_tile.py), for Hopper (sm_90a): one launch per
// layer, two bodies.
//
// What it computes: out = act(conv(in0; w0) [+ conv(in1; w1)] + shift
// [+ residual]) on NHWC tensors, 3x3 taps with pad 1, or the four sub-pixel
// phases of ConvTranspose 4x4 stride 2 as 2x2-tap convs whose outputs go to
// pixels (2m + a, 2n + b); a second input is walked as more input channels,
// so a concat is never written; sums and the epilogue in f32, one rounding.
//
// What bounds it on an H100: operations (a 384 -> 384 layer over 16 x 64^2
// positions is 174 GFLOP against 103 MB), so the bf16 body is built around
// the tensor cores and everything else feeds them:
//
// - wgmma. A block owns 16x16 output positions by N output channels (N =
//   128, 96, 64, 48, 32 or 16, the widest that divides Cout): two
//   warpgroups, each two m64nNk16 accumulators kept in registers over the
//   whole walk. The 64 rows of an m64 are an 8x8 patch of positions: the
//   input tile is staged as [channel octet][tile pixel][8 channels], the
//   no-swizzle core-matrix layout, so a tap (ky, kx) is only a start offset
//   of the A descriptor ((ky * tw + kx) * 16 bytes) and no im2col copy is
//   made. B is N-major (HWIO has Cout contiguous), read with the transpose
//   bit.
// - A ring of slots, 16 input channels a stage. The input tile (halo
//   included, zero-filled outside the image) comes by cp.async, 16 bytes a
//   thread. The weights come by ONE bulk copy a stage from a packed copy
//   that holds each (phase, output chunk, stage) slab contiguously in the
//   slot's layout: with cp.async for them too the body waited for the
//   copies, not for the products. With four slots two stages are in flight
//   while one is multiplied and one drains; wgmma.wait_group 1 keeps the
//   tensor cores busy across the barrier.
// - Blocks an SM (`wg_two_blocks`): a layer of 64 output channels or fewer
//   walks few stages (4 for 64 -> 64) and one block an SM fills and drains
//   its ring once a tile with nothing to cover it. Such layers are planned
//   for two blocks an SM: three slots where four would not leave a block
//   under half the SM's shared memory (64 output channels, 3x3: 87,104 B
//   against 116,096), so that one block's fill and epilogue run under the
//   other's products. Their registers (121 at most) allow two without a
//   launch bound; `__launch_bounds__(256, 2)` only let ptxas take more
//   registers for the narrow chunks and gained nothing (PERF.md). Wider
//   chunks keep one block of four slots.
// - Epilogue on the accumulator fragment: shift, skip add (read then written
//   by the same thread, so residual may alias out) and ReLU in f32, one
//   rounding; the four lanes of a quad exchange their 4-byte pairs so that
//   every store is 16 bytes (a 4-byte store writes half sectors, and the
//   stores then cost more than a short layer's products).
// - The output chunk is the fastest block index, so the blocks that share an
//   input tile run together and find it in L2.
//
// fp32, and layers with a width that is no multiple of 16 (the 3-channel
// first and last layers), run f32 FMAs: an 8x16 tile by 32 output channels,
// one pixel and 8 output channels per thread, input channels in chunks of
// 32; a tail's last layer has the tanh, guidance, blend and clip epilogue.
// chip_smoke.py prints every layer's time beside its bound and a cuDNN call;
// chip_conv_steps.py what each part of the wgmma body gives; PERF.md keeps
// the readings.
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "conv_tile.cuh"
#include "wgmma.cuh"

namespace {
using adam::ConvArgs;
using namespace adam::wg;

// ---- the FMA body's tile ---------------------------------------------------
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kPix = kTileH * kTileW;       // output positions per block
constexpr int kCoChunk = 32;                // output channels per block
constexpr int kKc = 32;                     // input channels per staged chunk
constexpr int kMaxTilePix = (kTileH + 2) * (kTileW + 2);

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

// ---- bf16 wgmma body -------------------------------------------------------
constexpr int kWgTile = 16;        // 16x16 output positions: four 8x8 patches
constexpr int kWgKc = 16;          // input channels per stage: one k16 step per tap
constexpr int kWgThreads = 256;    // two warpgroups, each two m64 patches
// Shared memory a block may take so that two fit an SM (228 KB, 1 KB of it
// reserved per block).
constexpr size_t kWgTwoBlockSmem = (233472 - 2 * 1024) / 2;

// The staged input tile of a stage: [channel octet (2)][tile pixel][8 channels],
// 16 bytes per pixel per octet, an octet plane padded to 2 mod 8 pixels so that
// the two octets of neighbouring pixels fall into different bank groups.
template <int KS> struct WgTile {
  static constexpr int tw = kWgTile + KS - 1;
  static constexpr int pix = tw * tw;
  static constexpr int plane = ((pix + 5) / 8) * 8 + 2;   // in 16-byte units
  static constexpr int a_bytes = 2 * plane * 16;
};

constexpr int kWgBarrierBytes = 128;   // one mbarrier per slot, ahead of the slots

constexpr size_t wg_smem_bytes(int n, int ks, int stages) {
  return kWgBarrierBytes +
         size_t(stages) *
             ((ks == 3 ? WgTile<3>::a_bytes : WgTile<2>::a_bytes) + ks * ks * kWgKc * n * 2);
}

// The plan of a layer whose block is n output channels wide: two blocks an
// SM or one, and with it the ring's slots (four, or three where four would
// not let two blocks fit). ops/kernels/conv_tile.py:conv_tile_plan mirrors it.
constexpr bool wg_two_blocks(int n, int ks) { return n <= 64; }
constexpr int wg_stages(int n, int ks) {
  return wg_two_blocks(n, ks) && wg_smem_bytes(n, ks, 4) > kWgTwoBlockSmem ? 3 : 4;
}
constexpr size_t wg_plan_smem(int n, int ks) { return wg_smem_bytes(n, ks, wg_stages(n, ks)); }

// The output-channel chunk of a block: the widest instantiated N that
// divides Cout (a multiple of 16).
inline int wg_cout_chunk(int cout) {
  for (int n : {128, 96, 64, 48, 32, 16})
    if (cout % n == 0) return n;
  return 0;
}

template <int N, int KS, int kWgStages>
__global__ void __launch_bounds__(kWgThreads)
conv_tile_wgmma_kernel(ConvArgs a) {
  using T = WgTile<KS>;
  constexpr int kTaps = KS * KS;
  constexpr int kABytes = T::a_bytes;
  constexpr int kBTap = kWgKc * N * 2;           // one tap's weight slab
  constexpr int kStage = kABytes + kTaps * kBTap;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t mbar0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t smem0 = mbar0 + kWgBarrierBytes;
  const int tid = threadIdx.x;

  // Block -> (tile, phase, output chunk), the chunk fastest: neighbouring
  // blocks read the same input tile while it is in L2.
  int bx = blockIdx.x;
  const int n_co = a.Cout / N;
  const int co0 = (bx % n_co) * N;
  bx /= n_co;
  const int phase = KS == 3 ? 0 : bx % 4;
  if (KS == 2) bx /= 4;
  const int tiles_x = (a.W + kWgTile - 1) / kWgTile;
  const int tx0 = (bx % tiles_x) * kWgTile;
  const int ty0 = (bx / tiles_x) * kWgTile;
  const int n = blockIdx.y;
  const int pa = phase >> 1, pb = phase & 1;
  // 3x3: taps reach from -1; phase (a, b): tap (u, v) reads (m - 1 + a + u, n - 1 + b + v).
  const int oy = ty0 + (KS == 3 ? -1 : pa - 1);
  const int ox = tx0 + (KS == 3 ? -1 : pb - 1);
  const int n0 = a.c[0] / kWgKc;
  const int n_stages = n0 + a.c[1] / kWgKc;

  // Stage j is 16 input channels of one source: its tile (halo included,
  // zero outside the image), 16 bytes a thread, and every tap's 16 x N
  // weights, which the packed weights hold as one contiguous slab in the
  // order the slot wants ([tap][k octet][n octet][8 k rows][8 n]): one
  // bulk copy by one thread.
  auto load = [&](int j) {
    const int s = j >= n0 ? 1 : 0;
    const int ls = s ? j - n0 : j;
    const int cc = ls * kWgKc;
    const int C = s ? a.c[1] : a.c[0];
    const __nv_bfloat16* in = static_cast<const __nv_bfloat16*>(s ? a.in[1] : a.in[0]);
    const uint32_t sA = smem0 + (j % kWgStages) * kStage;
    if (tid == 0) {
      const size_t slab = (static_cast<size_t>(phase) * n_co + co0 / N) * (C / kWgKc) + ls;
      const __nv_bfloat16* packed = static_cast<const __nv_bfloat16*>(s ? a.w[1] : a.w[0]);
      bulk_copy(sA + kABytes, packed + slab * (kTaps * kWgKc * N), kTaps * kBTap,
                mbar0 + (j % kWgStages) * 8);
    }
#pragma unroll
    for (int i = tid; i < T::pix * 2; i += kWgThreads) {
      const int p = i >> 1, v = i & 1;
      const int ty = p / T::tw, tx = p - ty * T::tw;
      const int yy = oy + ty, xx = ox + tx;
      const bool ok = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
      const __nv_bfloat16* src =
          ok ? in + ((static_cast<size_t>(n) * a.H + yy) * a.W + xx) * C + cc + v * 8 : in;
      cp_async16(sA + (v * T::plane + p) * 16, src, ok ? 16 : 0);
    }
  };

  // Warpgroup g owns tile rows 8g..8g+7: patch m is columns 8m..8m+7. Row r
  // of an m64 is patch pixel (r / 8, r % 8), so a tap is a start offset.
  const int wg = tid / 128;
  float acc[2][N / 2];
  uint64_t da0[2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
    da0[m] = wg_desc(smem0 + ((8 * wg) * T::tw + 8 * m) * 16, T::plane * 16, T::tw * 16);
  const uint64_t db0 = wg_desc(smem0 + kABytes, (N / 8) * 128, 128);

  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < kWgStages; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(mbar0 + j * 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kWgStages - 2; ++j) {
    if (j < n_stages) load(j);
    cp_async_commit();
  }
  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kWgStages - 3>();   // stage `it` has landed (this thread's part)
    mbar_wait(mbar0 + (it % kWgStages) * 8, (it / kWgStages) & 1);   // ... and its weights
    fence_proxy_async();
    __syncthreads();                  // ... everyone's; and slot it-2 is drained
    if (it + kWgStages - 2 < n_stages) load(it + kWgStages - 2);
    cp_async_commit();
    const uint64_t slot = static_cast<uint64_t>(((it % kWgStages) * kStage) >> 4);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const uint64_t db = db0 + slot + ((tap * kBTap) >> 4);
      const uint64_t atap = slot + (tap / KS) * T::tw + tap % KS;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wgmma_bf16<N>(acc[m], da0[m] + atap, db, tap == 0 ? it > 0 : 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                  // the stage before this one is drained
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[m][i]) :: "memory");

  // Epilogue on the accumulator fragment: thread (warp w, lane) holds rows
  // 16w + lane / 4 (+ 8) and columns 8j + 2 (lane % 4) (+ 1) of each m64.
  // Shift, skip add and ReLU in f32, one rounding; then the four lanes of a
  // quad, which hold 4 bytes each of four 8-channel octets of one pixel,
  // exchange them so that each lane stores one octet as 16 bytes.
  const int lane = tid & 31, w = (tid >> 5) & 3, q = lane >> 2, l = lane & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const __nv_bfloat16* residual = static_cast<const __nv_bfloat16*>(a.residual);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = ty0 + 8 * wg + 2 * w + h;
      const int x = tx0 + 8 * m + q;
      const bool ok = y < a.H && x < a.W;
      const size_t pix =
          KS == 3 ? (static_cast<size_t>(n) * a.H + y) * a.W + x
                  : (static_cast<size_t>(n) * 2 * a.H + 2 * y + pa) * (2 * a.W) + 2 * x + pb;
      const size_t base = pix * a.Cout + co0;
      uint32_t word[N / 8];
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 sh = *reinterpret_cast<const float2*>(a.shift + co0 + 8 * j + 2 * l);
        float v0 = acc[m][4 * j + 2 * h] + sh.x;
        float v1 = acc[m][4 * j + 2 * h + 1] + sh.y;
        if (residual != nullptr && ok) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(residual + base + 8 * j + 2 * l));
          v0 += r.x;
          v1 += r.y;
        }
        if (a.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
        word[j] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      // Octets in fours: in round r lane l hands its word of octet j0 + (l ^ r)
      // to lane l ^ r and gets that lane's word of octet j0 + l.
#pragma unroll
      for (int j0 = 0; j0 + 4 <= N / 8; j0 += 4) {
        uint32_t o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = l ^ r;
          const uint32_t mine = k == 0 ? word[j0] : k == 1 ? word[j0 + 1]
                              : k == 2 ? word[j0 + 2] : word[j0 + 3];
          const uint32_t got = r == 0 ? mine : __shfl_xor_sync(0xffffffffu, mine, r);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k == i) o[i] = got;
        }
        if (ok)
          *reinterpret_cast<uint4*>(out + base + 8 * (j0 + l)) = make_uint4(o[0], o[1], o[2], o[3]);
      }
      // Octets beyond a multiple of four (N = 48, 16): 4 bytes a lane.
#pragma unroll
      for (int j = (N / 8) & ~3; j < N / 8; ++j)
        if (ok) *reinterpret_cast<uint32_t*>(out + base + 8 * j + 2 * l) = word[j];
    }
  }
}

// The kernel of a layer's plan.
template <int N, int KS>
auto wg_kernel() {
  return conv_tile_wgmma_kernel<N, KS, wg_stages(N, KS)>;
}

template <int N, int KS>
int launch_wgmma(const ConvArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = wg_plan_smem(N, KS);
  auto kernel = wg_kernel<N, KS>();
  cudaError_t err = adam::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((a.H + kWgTile - 1) / kWgTile) * ((a.W + kWgTile - 1) / kWgTile);
  const dim3 grid(tiles * (KS == 3 ? 1 : 4) * (a.Cout / N), batch);
  kernel<<<grid, kWgThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM that the plan's kernel of this chunk and tap count gets
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
template <int N, int KS>
int occupancy_wgmma() {
  constexpr size_t smem = wg_plan_smem(N, KS);
  auto kernel = wg_kernel<N, KS>();
  int blocks = 0;
  cudaError_t err = adam::allow_dynamic_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kWgThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <int N>
int launch_wgmma_n(const ConvArgs& a, int batch, cudaStream_t stream) {
  return a.ksize == 3 ? launch_wgmma<N, 3>(a, batch, stream) : launch_wgmma<N, 2>(a, batch, stream);
}

template <int N>
int occupancy_wgmma_n(int ksize) {
  return ksize == 3 ? occupancy_wgmma<N, 3>() : occupancy_wgmma<N, 2>();
}

}  // namespace

namespace adam {

bool conv_uses_wgmma(int c0, int c1, int cout, int is_bf16) {
  return is_bf16 && c0 % 16 == 0 && c1 % 16 == 0 && cout % 16 == 0;
}

int launch_conv(const ConvArgs& a, int N, int is_bf16, cudaStream_t stream) {
  if (a.w[0] == nullptr || (a.in[1] != nullptr && a.w[1] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (conv_uses_wgmma(a.c[0], a.c[1], a.Cout, is_bf16)) {
    switch (wg_cout_chunk(a.Cout)) {
      case 128: return launch_wgmma_n<128>(a, N, stream);
      case 96: return launch_wgmma_n<96>(a, N, stream);
      case 64: return launch_wgmma_n<64>(a, N, stream);
      case 48: return launch_wgmma_n<48>(a, N, stream);
      case 32: return launch_wgmma_n<32>(a, N, stream);
      default: return launch_wgmma_n<16>(a, N, stream);
    }
  }
  if (is_bf16) return launch_fma<__nv_bfloat16, false>(a, N, stream);
  return launch_fma<float, false>(a, N, stream);
}

int launch_conv_final(const ConvArgs& a, int N, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_fma<__nv_bfloat16, true>(a, N, stream);
  return launch_fma<float, true>(a, N, stream);
}

}  // namespace adam

// One convolution: out = act(conv(in0; w0) [+ conv(in1; w1)] + shift
// [+ residual]). ksize 3: 3x3 taps, pad 1, out (N, H, W, Cout). ksize 2: the
// four sub-pixel phases of ConvTranspose(4, stride 2, pad 1), weights
// (4, 4, c0, Cout) [phase, tap], out (N, 2H, 2W, Cout). in1 may be null.
// residual may equal out: each element is read, then written, by one
// thread. Channel counts must be multiples of 8 except a single input of
// any width through the scalar path.
extern "C" int conv_tile(const void* in0, const void* w0, const void* wp0, int c0,
                         const void* in1, const void* w1, const void* wp1, int c1,
                         const void* shift, const void* residual, void* out, int N, int H,
                         int W, int Cout, int ksize, int relu, int is_bf16, void* stream) {
  if ((ksize != 2 && ksize != 3) || c0 < 1 || Cout < 1 || (in1 != nullptr && c1 < 1) ||
      N < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a = {};
  a.c[0] = c0;
  a.c[1] = in1 != nullptr ? c1 : 0;
  const bool wgmma = adam::conv_uses_wgmma(a.c[0], a.c[1], Cout, is_bf16);
  a.in[0] = in0; a.w[0] = wgmma ? wp0 : w0;
  a.in[1] = in1; a.w[1] = wgmma ? wp1 : w1;
  a.shift = static_cast<const float*>(shift);
  a.residual = residual;
  a.out = out;
  a.H = H; a.W = W; a.Cout = Cout; a.ksize = ksize; a.relu = relu;
  return adam::launch_conv(a, N, is_bf16, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per block of the body that `conv_tile` takes for
// these widths (ops/kernels/conv_tile.py:conv_tile_plan mirrors it).
extern "C" int conv_tile_smem_bytes(int c0, int c1, int Cout, int ksize, int is_bf16) {
  if (adam::conv_uses_wgmma(c0, c1, Cout, is_bf16)) {
    const int n = wg_cout_chunk(Cout);
    return static_cast<int>(wg_plan_smem(n, ksize));
  }
  return static_cast<int>(kFmaSmem);
}

// Blocks an SM that the wgmma body's kernel for a layer of Cout output
// channels and this tap count gets on the current device, as the occupancy
// API reads it from its registers and shared memory; a negative CUDA error
// if it could not be read.
extern "C" int conv_tile_blocks_per_sm(int Cout, int ksize) {
  if (Cout % 16 != 0 || (ksize != 2 && ksize != 3)) return -static_cast<int>(cudaErrorInvalidValue);
  switch (wg_cout_chunk(Cout)) {
    case 128: return occupancy_wgmma_n<128>(ksize);
    case 96: return occupancy_wgmma_n<96>(ksize);
    case 64: return occupancy_wgmma_n<64>(ksize);
    case 48: return occupancy_wgmma_n<48>(ksize);
    case 32: return occupancy_wgmma_n<32>(ksize);
    default: return occupancy_wgmma_n<16>(ksize);
  }
}
