// K1: the eval-mode low branch (LightweightDehazeModel) for Hopper (sm_90a).
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
// with weights and the activations between layers in the compute dtype and
// every sum, shift, skip add, ReLU, sigmoid and blend in f32, one rounding
// per layer.
//
// What bounds it on an H100: at c = 32 and 16 x 256^2 the branch is 139 GFLOP
// (0.14 ms of tensor core) but one activation is 67 MB, more than the 50 MB
// L2, so a launch per layer moves 1.3 GB (0.39 ms) and a block that restages
// the layer's weights for every 128 positions spends most of its life
// loading. The TPU kernel kept the image in VMEM across all nine layers; a
// whole 256x256x32 activation (4 MiB) does not fit 227 KB of shared memory,
// but a tile of it with the halo of two layers does.
//
// Design of the bf16 body (c = 16, 32, 48 or 64), "fused groups":
//
// - n_blocks + 1 launches instead of 2 n_blocks + 3: [3 -> c, rb1a, rb1b],
//   one [rb_a, rb_b] per further residual block, [c -> c, c -> 3 + blend].
//   A block is persistent (one per SM, or as many as fit), loads the group's
//   packed weights and shifts into shared memory once and walks T x T output
//   tiles. Per tile it stages the input with the halo the group needs
//   ((T + 4)^2 positions), runs the group's layers from one shared-memory
//   buffer into the other, each on a ring one position smaller (halo
//   recompute: 1.16x the products of a c -> c pair at T = 32, the wrapped
//   columns below included), and writes the last layer's T x T result to
//   device memory once. Whole-chain fusion would need a 34 x 34 input for a
//   16 x 16 output, 2.3x the products.
// - The next tile's input is copied (cp.async) while the last layer of this
//   one runs: the staged buffer is free by then, because a residual group
//   reads its skip from device memory (the tile it staged a tile ago, still
//   in L2) and not from the buffer's centre; the first group, whose skip is
//   its own first layer's output, reads it from shared memory and prefetches
//   only the 3-channel tile. Two barriers a tile (four in the first group).
// - Positions of a recomputed ring that lie OUTSIDE THE IMAGE are stored as
//   0, not as relu(shift): the next conv pads with zeros there.
// - Every layer is wgmma (m64nNk16, f32 accumulators in registers, A and B
//   from shared memory without swizzle). A buffer is [channel octet][flat
//   position][8 channels] with one pitch P = T + 4 for all layers of a
//   group, and the 64 rows of a product are 64 CONSECUTIVE flat positions
//   (stride between 8-row groups = 128 bytes), so a tap (ky, kx) is the start
//   offset (ky * P + kx) * 16 bytes and a ring of any size is walked without
//   8 x 8 patches. Positions whose taps wrap into the next row (the last
//   columns of a row) are computed and never used: 2/P of the work, less than
//   padding a 34 x 34 ring to 40 x 40 patches (1.38x).
// - The first layer (3 -> c) is one K = 32 product per 64 positions over
//   rows built in shared memory from the 3-channel tile (27 taps x channels,
//   5 zeros); the last (c -> 3) is m64n8k16 with the sigmoid and the blend on
//   the accumulators. No layer of this body runs on FMAs.
// - What bounds it now (PERF.md has the readings): not the products (a
//   quarter of a group's time) nor one stream of memory, but the instruction
//   stream: N = c is narrow, an m64n32k16 is 16 clocks of tensor core for two
//   descriptors and an instruction in each of four warps, and a thread's
//   epilogue handles 16 values a unit.
//   Four warpgroups a block take the units of a layer in turn, one unit in
//   flight each; what the epilogue needs from device memory is asked for
//   before the products. chip_smoke.py prints the time beside the bound,
//   chip_conv_steps.py what each part gives.
//
// The same body runs K3's head group (ops/kernels/tail_chain.py): the medium
// tail's last two layers, c -> c/2 and c/2 -> 3 with tanh, x + res and the
// clip, at c = 32 or 64, as one launch in kLast's manner (kTailHead). The
// c/2-wide activation never leaves shared memory, and the last layer is
// m64n8k16 with its epilogue on the accumulators. It replaced a launch of the
// shared conv body (c -> c/2, whose output made a round trip through device
// memory) and one of the f32 FMA body (c/2 -> 3, a block of 32 output
// channels for 3 real ones, no tensor core).
//
// fp32, and bf16 at the other widths (multiples of 8), keep one launch per
// layer of the f32 FMA body: a block computes an 8x16 output tile for up to
// 32 output channels, stages the input tile with a 1-pixel zero halo as f32
// at row stride Cin+1 and the layer's weights, one pixel and 8 output
// channels per thread. The body is chosen by dtype and width before any
// launch; ops/kernels/lightweight_chain.py mirrors the rule (`chain_plan`).
#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

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

// ---- bf16 fused groups -----------------------------------------------------
using namespace adam::wg;

constexpr int kFirst = 0;   // 3 -> c, then the first residual block
constexpr int kRes = 1;     // one residual block
constexpr int kLast = 2;    // c -> c, then c -> 3 with sigmoid and blend
constexpr int kTailHead = 3;   // K3's head: c -> c/2, then c/2 -> 3 with tanh, x + res and clip
constexpr int kFuWarpgroups = 4;   // a block: they take a layer's units in turn
constexpr int kFuThreads = 128 * kFuWarpgroups;
constexpr int kFuTiles[] = {32, 28, 24, 20, 16, 12, 8};   // output tile sides, widest first

// Positions of one channel-octet plane that holds `rows` rows at pitch
// `pitch`: the last product of a layer starts below position rows * pitch
// and reads 64 positions from a tap offset of at most 2 * pitch + 2 (66 more
// than the rows), rounded so that planes are 2 mod 8 positions apart (the
// octets of a staged pixel then fall into different banks).
__host__ __device__ constexpr int fu_plane(int rows, int pitch) {
  return ((rows * pitch + 66 + 7) / 8) * 8 + 2;
}

struct FuLayout {
  int w_bytes, shift_bytes, buf1_bytes, buf2_bytes, xs_bytes;
  __host__ __device__ int total() const {
    return w_bytes + shift_bytes + buf1_bytes + buf2_bytes + xs_bytes;
  }
};

// Shared memory of a group at width C and tile side T: the packed weights
// and the shifts of its layers, buffer 1 (T + 4 rows: the staged input; for
// kFirst the first layer's output), buffer 2 (T + 2 rows: the middle layer's
// output, c/2 wide in kTailHead; for kFirst first the K = 32 rows of the first
// layer, T + 4 rows of 4 octets), and for kFirst the 3-channel f32 tile (T + 6
// rows).
__host__ __device__ inline FuLayout fu_layout(int C, int kind, int T) {
  const int P = T + 4, oct = C / 8;
  FuLayout L;
  L.w_bytes = kind == kFirst ? 64 * C + 36 * C * C
            : kind == kRes   ? 36 * C * C
            : kind == kLast  ? 18 * C * C + 144 * C
                             : 9 * C * C + 72 * C;
  L.shift_bytes = 4 * (kind == kFirst ? 3 * C : kind == kRes ? 2 * C
                       : kind == kLast ? C + 8 : C / 2 + 8);
  L.buf1_bytes = oct * fu_plane(T + 4, P) * 16;
  const int mid = (kind == kTailHead ? oct / 2 : oct) * fu_plane(T + 2, P);
  const int rows32 = kind == kFirst ? 4 * fu_plane(T + 4, P) : 0;
  L.buf2_bytes = (mid > rows32 ? mid : rows32) * 16;
  L.xs_bytes = kind == kFirst ? (((T + 6) * (T + 6) * 12 + 15) / 16) * 16 : 0;
  return L;
}

// K1's groups take c = 16 to 64; K3's head group c = 32 or 64 (c/2 is then
// a multiple of 16, one k16 step of its last layer or two).
inline bool fu_width(int C, int kind) {
  return kind == kTailHead ? C == 32 || C == 64 : C == 16 || C == 32 || C == 48 || C == 64;
}

// The widest tile whose largest group fits a block, or 0: kFirst for K1's
// chain, the group itself for K3's head.
inline int fu_tile(int C, int kind = kFirst) {
  if (!fu_width(C, kind)) return 0;
  for (int T : kFuTiles)
    if (static_cast<size_t>(fu_layout(C, kind, T).total()) <= adam::kMaxDynamicSmem) return T;
  return 0;
}

struct GroupArgs {
  const float* x;            // the branch input (N, H, W, 3): kFirst convolves it, kLast and
                             // kTailHead add it to their result
  const __nv_bfloat16* in;   // kRes, kLast, kTailHead: the activation (N, H, W, C)
  const __nv_bfloat16* w;    // the group's packed weights, layer after layer
  const float* shift;        // the group's shifts, layer after layer (the c -> 3 bias padded to 8)
  __nv_bfloat16* out;        // kFirst, kRes: the activation (N, H, W, C)
  float* out_f32;            // kLast, kTailHead: the result (N, H, W, 3)
  float alpha;
  int N, H, W, T;
};

// What a layer does with its accumulators.
constexpr int kToSmem = 0;       // shift, ReLU, zero outside the image, one rounding -> the other buffer
constexpr int kSkipSmemOut = 1;  // shift, skip add from the centre of a staged buffer, ReLU, one rounding -> device memory
constexpr int kSkipGlobalOut = 2;  // the same, the skip read from the group's input in device memory
constexpr int kBlendOut = 3;     // bias, sigmoid, blend with the image -> device memory (f32, 3 channels)
constexpr int kTanhOut = 4;      // bias, tanh, + the image, clip to [0, 1] -> device memory (f32, 3 channels)

struct LayerIO {
  uint32_t a_base, a_plane;    // input buffer and its plane stride (shared address space, bytes)
  uint32_t b_base;             // the layer's packed weights (shared address space)
  const float* shift;          // shared memory
  int rows;                    // output rows (the pitch is P for input and output)
  int oy, ox;                  // image coordinates of output position (0, 0)
  unsigned char* dst;          // kToSmem: the output buffer
  uint32_t dst_plane;
  const unsigned char* skip;   // kSkipSmemOut: the buffer whose centre is added
  uint32_t skip_plane;
};

// What one thread needs for its two rows of a unit before and after the
// products. Thread (warp, lane) of a warpgroup holds rows 16 warp + lane / 4
// (+ 8) and columns 8 j + 2 (lane % 4) (+ 1).
template <int N, int EPI>
struct UnitRows {
  int q[2];                  // flat output positions
  bool inside[2], ok[2];     // inside the image; a position this tile writes
  size_t pix[2];             // (n, y, x) flattened, where ok
  uint32_t skip_w[2][EPI == kSkipGlobalOut ? N / 8 : 1];
  float image[2][2];         // kBlendOut, kTanhOut
};

// One layer of a group over the whole tile: the warpgroups take the units of
// 64 consecutive flat positions in turn, one unit in flight each (two in
// flight a warpgroup, so that one's epilogue passes under the other's
// products, was slower: PERF.md). N output channels, KSTEPS k16 steps per
// tap, TAPS taps (9, or 1 for the first layer's ready-made rows). What the
// epilogue needs from device memory (the skip, the image) is asked for
// before the products, so that its latency passes under them.
template <int N, int KSTEPS, int TAPS, int EPI>
__device__ __forceinline__ void fu_layer(const LayerIO& io, const GroupArgs& g, int n, int P) {
  constexpr bool kImageOut = EPI == kBlendOut || EPI == kTanhOut;   // 3 channels, f32
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, lane = tid & 31, q8 = lane >> 2, l = lane & 3;
  const int units = (io.rows * P + 63) >> 6;

  // This thread's shifts: columns 8 j + 2 l (+ 1) whatever the unit.
  float2 sh[kImageOut ? 1 : N / 8];
  if constexpr (!kImageOut) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      sh[j] = *reinterpret_cast<const float2*>(io.shift + 8 * j + 2 * l);
  }

  auto rows_of = [&](int u, UnitRows<N, EPI>& r) {
    const int q0 = u * 64 + warp * 16 + q8;
    const int y0 = q0 / P, x0 = q0 - y0 * P;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The second row is 8 positions on: at most one row down (P > 8).
      r.q[h] = q0 + 8 * h;
      const bool wrap = h == 1 && x0 + 8 >= P;
      const int y = y0 + (wrap ? 1 : 0), x = x0 + 8 * h - (wrap ? P : 0);
      const int gy = io.oy + y, gx = io.ox + x;
      r.inside[h] = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
      r.ok[h] = r.inside[h] && y < g.T && x < g.T;
      r.pix[h] = (static_cast<size_t>(n) * g.H + gy) * g.W + gx;
      if constexpr (EPI == kSkipGlobalOut) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          r.skip_w[h][j] = r.ok[h] ? *reinterpret_cast<const uint32_t*>(
                                         g.in + r.pix[h] * N + 8 * j + 2 * l)
                                   : 0u;
      }
      if constexpr (kImageOut) {
        // N = 8: columns 0..2 are the image's channels; lane % 4 = 0 holds 0
        // and 1, lane % 4 = 1 holds 2 (and a padded column).
#pragma unroll
        for (int k = 0; k < 2; ++k)
          r.image[h][k] = r.ok[h] && 2 * l + k < 3 ? g.x[r.pix[h] * 3 + 2 * l + k] : 0.f;
      }
    }
  };

  auto products = [&](int u, float (&acc)[N / 2]) {
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const uint32_t a_tap =
          io.a_base + (u * 64 + (TAPS == 9 ? (tap / 3) * P + tap % 3 : 0)) * 16;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint64_t da = wg_desc(a_tap + ks * 2 * io.a_plane, io.a_plane, 128);
        const uint64_t db =
            wg_desc(io.b_base + (tap * KSTEPS + ks) * (16 * N * 2), (N / 8) * 128, 128);
        wgmma_bf16<N>(acc, da, db, (tap | ks) != 0);   // the first product clears acc
      }
    }
    wgmma_commit();
  };

  auto epilogue = [&](const UnitRows<N, EPI>& r, float (&acc)[N / 2]) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (EPI == kToSmem) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float v0 = fmaxf(acc[4 * j + 2 * h] + sh[j].x, 0.f);
          float v1 = fmaxf(acc[4 * j + 2 * h + 1] + sh[j].y, 0.f);
          if (!r.inside[h]) v0 = v1 = 0.f;   // the next conv pads with zeros outside the image
          *reinterpret_cast<__nv_bfloat162*>(io.dst + j * io.dst_plane + r.q[h] * 16 + l * 4) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else if constexpr (EPI == kSkipSmemOut || EPI == kSkipGlobalOut) {
        const size_t base = r.pix[h] * N;
        uint32_t word[N / 8];
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          uint32_t sw;
          if constexpr (EPI == kSkipGlobalOut)
            sw = r.skip_w[h][j];
          else
            sw = *reinterpret_cast<const uint32_t*>(io.skip + j * io.skip_plane +
                                                    (r.q[h] + 2 * P + 2) * 16 + l * 4);
          const float2 sk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sw));
          const float v0 = fmaxf(acc[4 * j + 2 * h] + sh[j].x + sk.x, 0.f);
          const float v1 = fmaxf(acc[4 * j + 2 * h + 1] + sh[j].y + sk.y, 0.f);
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
          word[j] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        // The four lanes of a quad hold 4 bytes each of every octet of one
        // position: in round x lane l hands its word of octet j0 + (l ^ x) to
        // lane l ^ x and gets that lane's word of octet j0 + l, so that each
        // lane stores one octet as 16 bytes.
#pragma unroll
        for (int j0 = 0; j0 + 4 <= N / 8; j0 += 4) {
          uint32_t o[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int k = l ^ x;
            const uint32_t mine = k == 0 ? word[j0] : k == 1 ? word[j0 + 1]
                                : k == 2 ? word[j0 + 2] : word[j0 + 3];
            const uint32_t got = x == 0 ? mine : __shfl_xor_sync(0xffffffffu, mine, x);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k == i) o[i] = got;
          }
          if (r.ok[h])
            *reinterpret_cast<uint4*>(g.out + base + 8 * (j0 + l)) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
        // Octets beyond a multiple of four (c = 48, 16): 4 bytes a lane.
#pragma unroll
        for (int j = (N / 8) & ~3; j < N / 8; ++j)
          if (r.ok[h]) *reinterpret_cast<uint32_t*>(g.out + base + 8 * j + 2 * l) = word[j];
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (r.ok[h] && 2 * l + k < 3) {
            const float v = acc[2 * h + k] + io.shift[2 * l + k];
            // The image as the compute dtype holds it.
            const float xin = __bfloat162float(__float2bfloat16(r.image[h][k]));
            if constexpr (EPI == kBlendOut) {
              const float sg = 1.f / (1.f + expf(-v));
              g.out_f32[r.pix[h] * 3 + 2 * l + k] = (1.f - g.alpha) * xin + g.alpha * sg;
            } else {
              const float res = tanhf(v);
              g.out_f32[r.pix[h] * 3 + 2 * l + k] = fminf(fmaxf(xin + res, 0.f), 1.f);
            }
          }
        }
      }
    }
  };

  for (int u = tid >> 7; u < units; u += kFuWarpgroups) {
    UnitRows<N, EPI> r;
    float acc[N / 2];
    rows_of(u, r);
    wgmma_fence();
    products(u, acc);
    wgmma_wait<0>();
    epilogue(r, acc);
  }
}

template <int C, int KIND>
__global__ void __launch_bounds__(kFuThreads, 1)
lightweight_group_kernel(GroupArgs g) {
  extern __shared__ __align__(128) unsigned char fu_smem[];
  constexpr int kOct = C / 8;
  constexpr int kMid = KIND == kTailHead ? C / 2 : C;   // the middle layer's output width
  constexpr int kLayerBytes = 18 * C * kMid;    // the packed middle layer
  const int T = g.T, P = T + 4;
  const FuLayout L = fu_layout(C, KIND, T);
  unsigned char* s_w = fu_smem;
  float* s_shift = reinterpret_cast<float*>(fu_smem + L.w_bytes);
  unsigned char* buf1 = fu_smem + L.w_bytes + L.shift_bytes;
  unsigned char* buf2 = buf1 + L.buf1_bytes;
  float* s_x = reinterpret_cast<float*>(buf2 + L.buf2_bytes);   // kFirst: the 3-channel tile
  const uint32_t w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_w));
  const uint32_t b1 = static_cast<uint32_t>(__cvta_generic_to_shared(buf1));
  const uint32_t b2 = static_cast<uint32_t>(__cvta_generic_to_shared(buf2));
  const uint32_t x_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_x));
  const uint32_t pl4 = fu_plane(T + 4, P) * 16;   // plane stride of a T + 4 row buffer
  const uint32_t pl2 = fu_plane(T + 2, P) * 16;   // ... of a T + 2 row buffer
  const int tid = threadIdx.x;
  const int tiles_x = (g.W + T - 1) / T, tiles_y = (g.H + T - 1) / T;
  const int total = g.N * tiles_y * tiles_x;

  // Asynchronous copies of tile t's input, zero outside the image: kFirst
  // the 3-channel f32 tile with a halo of 3 (4 bytes a copy: its rows are not
  // 16-byte aligned), else the activation with a halo of 2 into buffer 1 (16
  // bytes a copy). The caller commits and, before the first read, waits.
  auto stage = [&](int t) {
    const int n = t / (tiles_y * tiles_x);
    const int ty0 = (t / tiles_x) % tiles_y * T, tx0 = t % tiles_x * T;
    if constexpr (KIND == kFirst) {
      const int xw = T + 6;
      for (int i = tid; i < xw * xw * 3; i += kFuThreads) {
        const int p = i / 3;
        const int yy = ty0 - 3 + p / xw, xx = tx0 - 3 + p % xw;
        const bool ok = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
        const float* src =
            ok ? g.x + ((static_cast<size_t>(n) * g.H + yy) * g.W + xx) * 3 + (i - p * 3) : g.x;
        cp_async4(x_addr + i * 4, src, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < P * P * kOct; i += kFuThreads) {
        const int p = i / kOct, v = i - p * kOct;
        const int yy = ty0 - 2 + p / P, xx = tx0 - 2 + p % P;
        const bool ok = yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
        const __nv_bfloat16* src =
            ok ? g.in + ((static_cast<size_t>(n) * g.H + yy) * g.W + xx) * C + v * 8 : g.in;
        cp_async16(b1 + v * pl4 + p * 16, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  if (blockIdx.x < total) stage(blockIdx.x);
  // The group's weights and shifts, once per block.
  for (int i = tid; i < L.w_bytes / 16; i += kFuThreads)
    reinterpret_cast<uint4*>(s_w)[i] = reinterpret_cast<const uint4*>(g.w)[i];
  for (int i = tid; i < L.shift_bytes / 4; i += kFuThreads) s_shift[i] = g.shift[i];

  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int n = t / (tiles_y * tiles_x);
    const int ty0 = (t / tiles_x) % tiles_y * T, tx0 = t % tiles_x * T;
    const int next = t + gridDim.x;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // this tile's input has landed; the tile before is done with both buffers

    if constexpr (KIND == kFirst) {
      // The first layer's A rows: position (y, x) of the (T + 4)^2 ring holds
      // k = (ky * 3 + kx) * 3 + ci -> tile (y + ky, x + kx, ci), k < 27, then 5 zeros.
      const int xw = T + 6;
      for (int q = tid; q < (T + 4) * P; q += kFuThreads) {
        const int y = q / P, x = q - y * P;
        const float* tile = s_x + (y * xw + x) * 3;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            constexpr int kNone = -1;
            const int k = 8 * o + e;
            const int off = k < 27 ? ((k / 9) * xw + (k / 3) % 3) * 3 + k % 3 : kNone;
            vals[e] = __float2bfloat16(off != kNone ? tile[off] : 0.f);
          }
          *reinterpret_cast<uint4*>(buf2 + o * pl4 + q * 16) =
              *reinterpret_cast<const uint4*>(vals);
        }
      }
      fence_proxy_async();
      __syncthreads();
      if (next < total) stage(next);   // the 3-channel tile is free: the next one lands under the layers
      LayerIO io = {};
      io.a_base = b2; io.a_plane = pl4; io.b_base = w_addr; io.shift = s_shift;
      io.rows = T + 4; io.oy = ty0 - 2; io.ox = tx0 - 2; io.dst = buf1; io.dst_plane = pl4;
      fu_layer<C, 2, 1, kToSmem>(io, g, n, P);
      fence_proxy_async();
      __syncthreads();
    }

    // The middle layer: buffer 1 (T + 4 rows) -> buffer 2 (T + 2 rows).
    constexpr int kW0 = KIND == kFirst ? 64 * C : 0;      // bytes of the first layer's weights
    constexpr int kS0 = KIND == kFirst ? C : 0;           // its shifts
    {
      LayerIO io = {};
      io.a_base = b1; io.a_plane = pl4; io.b_base = w_addr + kW0; io.shift = s_shift + kS0;
      io.rows = T + 2; io.oy = ty0 - 1; io.ox = tx0 - 1; io.dst = buf2; io.dst_plane = pl2;
      fu_layer<kMid, C / 16, 9, kToSmem>(io, g, n, P);
    }
    fence_proxy_async();
    __syncthreads();
    // Buffer 1 is free (a residual group reads its skip from device memory):
    // the next tile's input lands under the last layer.
    if (KIND != kFirst && next < total) stage(next);
    // The last layer: buffer 2 -> device memory.
    {
      LayerIO io = {};
      io.a_base = b2; io.a_plane = pl2; io.b_base = w_addr + kW0 + kLayerBytes;
      io.shift = s_shift + kS0 + kMid;
      io.rows = T; io.oy = ty0; io.ox = tx0; io.skip = buf1; io.skip_plane = pl4;
      if constexpr (KIND == kLast)
        fu_layer<8, C / 16, 9, kBlendOut>(io, g, n, P);
      else if constexpr (KIND == kTailHead)
        fu_layer<8, kMid / 16, 9, kTanhOut>(io, g, n, P);
      else if constexpr (KIND == kRes)
        fu_layer<C, C / 16, 9, kSkipGlobalOut>(io, g, n, P);
      else
        fu_layer<C, C / 16, 9, kSkipSmemOut>(io, g, n, P);
    }
  }
}

template <int C, int KIND>
int launch_group(const GroupArgs& g, cudaStream_t stream) {
  const size_t smem = fu_layout(C, KIND, g.T).total();
  if (smem > adam::kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lightweight_group_kernel<C, KIND>;
  cudaError_t err = adam::allow_dynamic_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFuThreads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = g.N * ((g.H + g.T - 1) / g.T) * ((g.W + g.T - 1) / g.T);
  kernel<<<min(tiles, sms * per_sm), kFuThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_group_c(int kind, const GroupArgs& g, cudaStream_t stream) {
  switch (kind) {
    case kFirst: return launch_group<C, kFirst>(g, stream);
    case kRes: return launch_group<C, kRes>(g, stream);
    case kLast: return launch_group<C, kLast>(g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block of the per-layer FMA body needs for a layer of
// Cin input channels, or -1 when that is beyond Hopper's per-block limit
// (the launch then refuses the layer).
extern "C" int conv3x3_smem_bytes(int Cin) {
  const size_t smem = smem_bytes(Cin);
  return smem > adam::kMaxDynamicSmem ? -1 : static_cast<int>(smem);
}

// The output tile side of the fused bf16 body at width C, or 0 when that
// body does not serve the width. ops/kernels/lightweight_chain.py mirrors
// this and the count below (`chain_plan`); tests/test_torch_cuda.py holds the
// two against each other.
extern "C" int lightweight_fused_tile(int C) { return fu_tile(C); }

// Shared memory of one block of a fused group (kind 0 first, 1 residual
// block, 2 last) at width C and tile side T.
extern "C" int lightweight_group_smem_bytes(int C, int kind, int T) {
  return fu_layout(C, kind, T).total();
}

// One fused group of the bf16 body. kind 0: x (N, H, W, 3) f32 -> out
// (N, H, W, C) bf16 through 3 -> c and the first residual block; kind 1: in
// -> out through one residual block (not in place: a tile reads its
// neighbours' halo); kind 2: in -> out (N, H, W, 3) f32 through c -> c, c ->
// 3, the sigmoid and the blend with x. w and shift are the group's packed
// weights and shifts (ops/kernels/lightweight_chain.py:pack_groups). The
// tile is lightweight_fused_tile(C).
extern "C" int lightweight_group(int kind, const void* x, const void* in, const void* w,
                                 const void* shift, void* out, float alpha, int N, int H,
                                 int W, int C, void* stream) {
  const int T = fu_tile(C);
  if (N < 1 || H < 1 || W < 1 || T < 1 || kind < kFirst || kind > kLast)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupArgs g = {};
  g.x = static_cast<const float*>(x);
  g.in = static_cast<const __nv_bfloat16*>(in);
  g.w = static_cast<const __nv_bfloat16*>(w);
  g.shift = static_cast<const float*>(shift);
  g.out = static_cast<__nv_bfloat16*>(out);
  g.out_f32 = static_cast<float*>(out);
  g.alpha = alpha;
  g.N = N; g.H = H; g.W = W; g.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_group_c<16>(kind, g, s);
    case 32: return launch_group_c<32>(kind, g, s);
    case 48: return launch_group_c<48>(kind, g, s);
    case 64: return launch_group_c<64>(kind, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The output tile side of K3's head group at width C, or 0 where the group
// does not serve the width. ops/kernels/lightweight_chain.py mirrors it
// (`head_tile`).
extern "C" int tail_head_tile(int C) { return fu_tile(C, kTailHead); }

// K3's head group (ops/kernels/tail_chain.py): h1 (N, H, W, C) bf16 -> out
// (N, H, W, 3) f32 = clip(x + tanh(conv(h) + bias), 0, 1) with h =
// relu(conv(h1) + t2) (C/2 channels, rounded to bf16, held in shared memory
// only) and x (N, H, W, 3) f32 rounded to bf16. w and shift are the group's
// packed weights and shifts (pack_group: the c -> c/2 layer, then the c/2 ->
// 3 one padded to 8). The tile is tail_head_tile(C).
extern "C" int tail_head_group(const void* x, const void* h1, const void* w, const void* shift,
                               void* out, int N, int H, int W, int C, void* stream) {
  const int T = fu_tile(C, kTailHead);
  if (N < 1 || H < 1 || W < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  GroupArgs g = {};
  g.x = static_cast<const float*>(x);
  g.in = static_cast<const __nv_bfloat16*>(h1);
  g.w = static_cast<const __nv_bfloat16*>(w);
  g.shift = static_cast<const float*>(shift);
  g.out_f32 = static_cast<float*>(out);
  g.N = N; g.H = H; g.W = W; g.T = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch_group<32, kTailHead>(g, s);
    case 64: return launch_group<64, kTailHead>(g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One ConvBlock or residual half on the FMA body: out = act(conv3x3(x) +
// shift [+ residual]). residual may equal out (the residual block's in-place
// update): each element is read and then written by the same thread.
extern "C" int conv3x3_bn_act(const void* x, const void* w, const void* shift,
                              const void* residual, void* out, int N, int H, int W,
                              int Cin, int Cout, int relu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
