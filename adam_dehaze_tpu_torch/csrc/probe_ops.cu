// The operation probes: ten mini-kernels, one per pattern (A-I and B8), for
// Hopper (sm_90a).
//
// Replace the TPU mini-kernels of tools/probe_mosaic_ops.py (_run and the
// inline pallas_call of pattern I), which bisected a Mosaic lowering crash of
// the high tail chain by compiling each operation pattern alone. On the
// H100 no such crash was met; the probes stay as the smallest programs that
// exercise the operations K4's and K6's attention passes are made of (a
// reduction over a whole image's rows, a 1-row matrix product, per-group
// selects, a partial store into scratch), so that a change of the compiler
// or of the CUDA runtime that breaks one of them names itself. Each pattern
// is one launch of its own.
//
// All read x (flat, 384) bf16 and write f32; w is (384, 128) f32, wrep
// (128, 384) f32. Bound by bytes (x read once, under 1 MB at flat 1088: 0.3
// µs), but a launch and two dependent rounds through memory take a few µs,
// so the design is about latency. Nine patterns reduce the
// columns of x over all rows; they share one kernel body, probe_kernel<Ep>,
// and differ only in the epilogue Ep that the last block runs:
//
// - The grid is a row band a block, about 64 rows each, at most kBandWaves
//   bands an SM (the SM count is read once per device). A block's 384
//   threads are 8 row lanes x 48 threads of 8 columns: each thread makes
//   16-byte loads, kUnroll rows in flight, and keeps (sum, max) of its 8
//   columns in f32. The block combines its lanes in shared memory, lane by
//   lane, and writes its band's column sums and maxima to the workspace.
// - A ticket counter behind __threadfence() names the last block to finish
//   (as Q1a's absmax_slices_kernel in int8_conv.cu). It resets the counter,
//   so no memset precedes a launch, combines the bands' partials in band
//   order (no float atomics: two calls give the same bits) and runs the
//   epilogue. Its products are f32 FMAs, as the TPU kernels' f32 dots.
//
// G reduces nothing: it reads x[0:8, 0:4] on one block.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kC4 = 384;
constexpr int kC = 96;
constexpr int kRows = 8;                    // rows of every result
constexpr int kThreads = 384;
constexpr int kGroups = kC4 / 8;            // 48 threads of 8 columns cover a row
constexpr int kLanes = kThreads / kGroups;  // 8 rows a step
constexpr int kUnroll = 8;                  // loads in flight a thread
constexpr int kBandRows = 64;               // a band's rows, at least
constexpr int kBandWaves = 2;               // bands an SM, at most
constexpr int kMaxBands = 512;
// The workspace: (kMaxBands, 2, 384) f32 partials, then the ticket counter.
constexpr int kTicketOffset = kMaxBands * 2 * kC4 * 4;
constexpr int kWorkspaceBytes = kTicketOffset + 16;

struct ProbeArgs {
  const __nv_bfloat16* x;
  const float* w;      // (384, 128): B and B8
  const float* wrep;   // (128, 384): E
  float* out;
  float* part;         // (bands, 2, 384): a band's column sums, then its maxima
  unsigned* ticket;    // blocks done; 0 between launches
  int flat;
  int band_rows;       // a multiple of kLanes
};

// Sum and max of the 8 bf16 values of u into s and m.
__device__ __forceinline__ void accumulate8(const uint4& u, float s[8], float m[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    s[2 * k] += f.x;
    s[2 * k + 1] += f.y;
    m[2 * k] = fmaxf(m[2 * k], f.x);
    m[2 * k + 1] = fmaxf(m[2 * k + 1], f.y);
  }
}

// A dot product of 128 terms, lhs[k] * rhs[k * ld], in four f32 FMA chains
// summed in a fixed order; 32 loads of rhs in flight.
__device__ __forceinline__ float dot128(const float* lhs, const float* rhs, int ld) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int k = 0; k < 128; k += 4)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = fmaf(lhs[k + q], __ldg(rhs + (k + q) * ld), acc[q]);
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The shared column reduction. Every block reduces its band into the
// workspace; the last block to finish combines the bands into sum[384] and
// mx[384] and returns true, the others return false. `stage` holds
// 2 x kLanes x 384 floats.
__device__ __forceinline__ bool reduce_columns(const ProbeArgs& a, float* stage, float* sum,
                                               float* mx) {
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int lane = t / kGroups, g = t % kGroups;
  const int r0 = blockIdx.x * a.band_rows;
  const int r1 = min(a.flat, r0 + a.band_rows);
  const uint4* x = reinterpret_cast<const uint4*>(a.x) + g;
  float s[8], m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    s[k] = 0.f;
    m[k] = -INFINITY;
  }
  for (int r = r0 + lane; r < r1; r += kLanes * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kLanes;
      v[u] = row < r1 ? __ldg(x + static_cast<size_t>(row) * kGroups)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * kLanes < r1) accumulate8(v[u], s, m);
  }
  float* my_sum = stage + lane * kC4 + 8 * g;
  float* my_max = stage + (kLanes + lane) * kC4 + 8 * g;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    my_sum[k] = s[k];
    my_max[k] = m[k];
  }
  __syncthreads();
  // Thread t owns column t: the block's lanes in lane order, to the workspace.
  float bs = 0.f, bm = -INFINITY;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    bs += stage[l * kC4 + t];
    bm = fmaxf(bm, stage[(kLanes + l) * kC4 + t]);
  }
  float* band = a.part + static_cast<size_t>(blockIdx.x) * 2 * kC4;
  band[t] = bs;
  band[kC4 + t] = bm;
  __threadfence();   // this band's partials are seen before its ticket
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return false;
  // The last block: every band is in. Ready the ticket for the next launch.
  if (t == 0) *a.ticket = 0u;
  __threadfence();
  float cs = 0.f, cm = -INFINITY;
  const float* p = a.part + t;
#pragma unroll 16
  for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
    cs += __ldcg(p + static_cast<size_t>(b) * 2 * kC4);
    cm = fmaxf(cm, __ldcg(p + static_cast<size_t>(b) * 2 * kC4 + kC4));
  }
  sum[t] = cs;
  mx[t] = cm;
  __syncthreads();
  return true;
}

// The epilogues: run by the last block's kThreads threads, on the column
// sums and maxima; `scratch` holds 2 x kLanes x 384 floats (the stage,
// free again).

// A: row reduction, out (8, 384) = sum + max of every column.
struct EpA {
  static __device__ void run(const ProbeArgs& a, const float* sum, const float* mx, float*) {
    const int t = threadIdx.x;
    for (int r = 0; r < kRows; ++r) a.out[r * kC4 + t] = sum[t] + mx[t];
  }
};

// B: (1, 384) @ (384, 128), the 1-row left side; out (8, 128). Thread t
// takes a third of the depth of column t % 128.
struct EpB {
  static __device__ void run(const ProbeArgs& a, const float* sum, const float*, float* scratch) {
    const int t = threadIdx.x, j = t % 128, part = t / 128;
    scratch[t] = dot128(sum + part * 128, a.w + part * 128 * 128 + j, 128);
    __syncthreads();
    if (t >= 128) return;
    const float h = (scratch[j] + scratch[128 + j]) + scratch[256 + j];
    for (int r = 0; r < kRows; ++r) a.out[r * 128 + j] = h;
  }
};

// B8: the same product with the left side broadcast to 8 rows first: every
// one of the 8 x 128 outputs is its own dot product.
struct EpB8 {
  static __device__ void run(const ProbeArgs& a, const float* sum, const float*, float* scratch) {
    float* lhs = scratch;                  // (8, 384)
    float* parts = scratch + kRows * kC4;  // (3, 8, 128)
    const int t = threadIdx.x, j = t % 128, part = t / 128;
    for (int r = 0; r < kRows; ++r) lhs[r * kC4 + t] = sum[t];
    __syncthreads();
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int k = part * 128; k < part * 128 + 128; k += 4) {
      float wk[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) wk[q] = __ldg(a.w + (k + q) * 128 + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 l = *reinterpret_cast<const float4*>(lhs + r * kC4 + k);
        acc[r] = fmaf(l.x, wk[0], acc[r]);
        acc[r] = fmaf(l.y, wk[1], acc[r]);
        acc[r] = fmaf(l.z, wk[2], acc[r]);
        acc[r] = fmaf(l.w, wk[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) parts[(part * kRows + r) * 128 + j] = acc[r];
    __syncthreads();
    for (int o = t; o < kRows * 128; o += kThreads)
      a.out[o] = (parts[o] + parts[kRows * 128 + o]) + parts[2 * kRows * 128 + o];
  }
};

// C: max over the four 96-wide channel groups of the column max, padded
// with zeros to 128; out (8, 128).
struct EpC {
  static __device__ void run(const ProbeArgs& a, const float*, const float* mx, float*) {
    const int c = threadIdx.x;
    if (c >= 128) return;
    const float v = c < kC ? fmaxf(fmaxf(mx[c], mx[kC + c]), fmaxf(mx[2 * kC + c], mx[3 * kC + c]))
                           : 0.f;
    for (int r = 0; r < kRows; ++r) a.out[r * 128 + c] = v;
  }
};

// D: the first 96-wide piece of the column max, four times side by side;
// out (8, 384).
struct EpD {
  static __device__ void run(const ProbeArgs& a, const float*, const float* mx, float*) {
    const int c = threadIdx.x;
    for (int r = 0; r < kRows; ++r) a.out[r * kC4 + c] = mx[c % kC];
  }
};

// E: (1, 128) @ (128, 384), a 1-row left side and a wide result; out (8, 384).
struct EpE {
  static __device__ void run(const ProbeArgs& a, const float*, const float* mx, float*) {
    const int c = threadIdx.x;
    const float g = dot128(mx, a.wrep + c, kC4);
    for (int r = 0; r < kRows; ++r) a.out[r * kC4 + c] = g;
  }
};

// F: broadcast multiply, rows 0-7 of x * column sum; out (8, 384).
struct EpF {
  static __device__ void run(const ProbeArgs& a, const float* sum, const float*, float*) {
    const int c = threadIdx.x;
    for (int r = 0; r < kRows; ++r)
      a.out[r * kC4 + c] = __bfloat162float(a.x[r * kC4 + c]) * sum[c];
  }
};

// H: the group max of C as four products with 0/1 selection matrices built
// from indices, the running max starting at 0; out (8, 128). Thread t takes
// a third of the depth of column t % 128, for all four products.
struct EpH {
  static __device__ void run(const ProbeArgs& a, const float*, const float* mx, float* scratch) {
    const int t = threadIdx.x, c = t % 128, part = t / 128;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = part * 128; i < part * 128 + 128; ++i)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float sel = (i == c + p * kC && c < kC) ? 1.f : 0.f;
        dot[p] = fmaf(mx[i], sel, dot[p]);
      }
#pragma unroll
    for (int p = 0; p < 4; ++p) scratch[(p * 3 + part) * 128 + c] = dot[p];
    __syncthreads();
    if (t >= 128) return;
    float acc = 0.f;
    for (int p = 0; p < 4; ++p) {
      const float* d = scratch + p * 3 * 128 + c;
      acc = fmaxf(acc, (d[0] + d[128]) + d[256]);
    }
    for (int r = 0; r < kRows; ++r) a.out[r * 128 + c] = acc;
  }
};

// I: a partial store into scratch: the first 128 columns of an (8, 384)
// shared buffer are written and read back, the rest is never touched;
// out (8, 128).
struct EpI {
  static __device__ void run(const ProbeArgs& a, const float* sum, const float*, float* scratch) {
    const int c = threadIdx.x;
    if (c < 128)
      for (int r = 0; r < kRows; ++r) scratch[r * kC4 + c] = sum[c];
    __syncthreads();
    if (c < 128)
      for (int r = 0; r < kRows; ++r) a.out[r * 128 + c] = scratch[r * kC4 + c];
  }
};

// The nine reducing patterns: the shared column reduction, then Ep.
template <class Ep>
__global__ void __launch_bounds__(kThreads) probe_kernel(const ProbeArgs a) {
  __shared__ __align__(16) float s_stage[2 * kLanes * kC4];
  __shared__ float s_sum[kC4], s_max[kC4];
  if (reduce_columns(a, s_stage, s_sum, s_max)) Ep::run(a, s_sum, s_max, s_stage);
}

// G: per-group select: column c of the result takes x[r, p] for its group
// p = c / 96, built as four masked adds; out (8, 384).
__global__ void __launch_bounds__(kC4) probe_select_kernel(const ProbeArgs a) {
  const int c = threadIdx.x;
  for (int r = 0; r < kRows; ++r) {
    float acc = 0.f;
    for (int p = 0; p < 4; ++p) {
      const float gp = __bfloat162float(a.x[r * kC4 + p]);
      acc += (c / kC == p) ? gp : 0.f;
    }
    a.out[r * kC4 + c] = acc;
  }
}

__global__ void probe_empty_kernel() {}

// The bands of x's rows: about kBandRows each, at most kBandWaves an SM and
// kMaxBands; the SM count is read once per device (a host thread's cache).
cudaError_t plan_bands(int flat, int* bands, int* band_rows) {
  thread_local int known_dev = -1, sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != known_dev) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    known_dev = dev;
  }
  const int most = std::min(kMaxBands, kBandWaves * sms);
  const int want = std::max(1, std::min(most, (flat + kBandRows - 1) / kBandRows));
  const int rows = ((flat + want - 1) / want + kLanes - 1) / kLanes * kLanes;
  *band_rows = rows;
  *bands = (flat + rows - 1) / rows;
  return cudaSuccess;
}

}  // namespace

// The workspace a probe_op launch takes (bytes, zeroed once before its
// first launch; it is zero again after every launch). One a stream: two
// launches on two streams must not share one.
extern "C" int probe_workspace_bytes() { return kWorkspaceBytes; }

// Probe `which` (0-9: A, B, B8, C, D, E, F, G, H, I) on x (flat, 384) bf16,
// 16-byte aligned, flat >= 8; work: probe_workspace_bytes() of workspace.
extern "C" int probe_op(int which, const void* x, const void* w, const void* wrep, void* out,
                        void* work, int flat, void* stream) {
  if (flat < kRows || which < 0 || which > 9) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ProbeArgs a{static_cast<const __nv_bfloat16*>(x),
              static_cast<const float*>(w),
              static_cast<const float*>(wrep),
              static_cast<float*>(out),
              static_cast<float*>(work),
              reinterpret_cast<unsigned*>(static_cast<char*>(work) + kTicketOffset),
              flat,
              0};
  if (which == 7) {
    probe_select_kernel<<<1, kC4, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int bands = 0;
  cudaError_t err = plan_bands(flat, &bands, &a.band_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (which) {
    case 0: probe_kernel<EpA><<<bands, kThreads, 0, s>>>(a); break;
    case 1: probe_kernel<EpB><<<bands, kThreads, 0, s>>>(a); break;
    case 2: probe_kernel<EpB8><<<bands, kThreads, 0, s>>>(a); break;
    case 3: probe_kernel<EpC><<<bands, kThreads, 0, s>>>(a); break;
    case 4: probe_kernel<EpD><<<bands, kThreads, 0, s>>>(a); break;
    case 5: probe_kernel<EpE><<<bands, kThreads, 0, s>>>(a); break;
    case 6: probe_kernel<EpF><<<bands, kThreads, 0, s>>>(a); break;
    case 8: probe_kernel<EpH><<<bands, kThreads, 0, s>>>(a); break;
    case 9: probe_kernel<EpI><<<bands, kThreads, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel: the card's launch floor, beside the probes.
extern "C" int probe_empty(void* stream) {
  probe_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
