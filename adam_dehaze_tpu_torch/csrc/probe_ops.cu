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
// or of the CUDA runtime that breaks one of them names itself.
//
// All read x (flat, 384) bf16 and write f32; w is (384, 128) f32, wrep
// (128, 384) f32. One block of 384 threads each, thread c on column c: the
// arrays are under 1 MB and the probes are about being right, not fast
// (bound by bytes: x read once).
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kC4 = 384;
constexpr int kC = 96;
constexpr int kRows = 8;

// Column c of x reduced over all rows: (sum, max).
__device__ __forceinline__ void column_reduce(const __nv_bfloat16* x, int flat, int c,
                                              float* sum, float* mx) {
  float s = 0.f, m = -INFINITY;
  for (int r = 0; r < flat; ++r) {
    const float v = __bfloat162float(x[static_cast<size_t>(r) * kC4 + c]);
    s += v;
    m = fmaxf(m, v);
  }
  *sum = s;
  *mx = m;
}

// A: row reduction, out (8, 384) = sum + max of every column.
__global__ void probe_a(const __nv_bfloat16* x, float* out, int flat) {
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  for (int r = 0; r < kRows; ++r) out[r * kC4 + c] = s + m;
}

// B: (1, 384) @ (384, 128), the 1-row left side; out (8, 128).
__global__ void probe_b(const __nv_bfloat16* x, const float* w, float* out, int flat) {
  __shared__ float s_sum[kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  s_sum[c] = s;
  __syncthreads();
  if (c >= 128) return;
  float h = 0.f;
  for (int k = 0; k < kC4; ++k) h = fmaf(s_sum[k], w[k * 128 + c], h);
  for (int r = 0; r < kRows; ++r) out[r * 128 + c] = h;
}

// B8: the same product with the left side broadcast to 8 rows first: every
// one of the 8 x 128 outputs is its own dot product.
__global__ void probe_b8(const __nv_bfloat16* x, const float* w, float* out, int flat) {
  __shared__ float s_lhs[kRows][kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  for (int r = 0; r < kRows; ++r) s_lhs[r][c] = s;
  __syncthreads();
  for (int o = c; o < kRows * 128; o += kC4) {
    const int r = o / 128, j = o % 128;
    float h = 0.f;
    for (int k = 0; k < kC4; ++k) h = fmaf(s_lhs[r][k], w[k * 128 + j], h);
    out[o] = h;
  }
}

// C: max over the four 96-wide channel groups of the column max, padded
// with zeros to 128; out (8, 128).
__global__ void probe_c(const __nv_bfloat16* x, float* out, int flat) {
  __shared__ float s_max[kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  s_max[c] = m;
  __syncthreads();
  if (c >= 128) return;
  float v = 0.f;
  if (c < kC)
    v = fmaxf(fmaxf(s_max[c], s_max[kC + c]), fmaxf(s_max[2 * kC + c], s_max[3 * kC + c]));
  for (int r = 0; r < kRows; ++r) out[r * 128 + c] = v;
}

// D: the first 96-wide piece of the column max, four times side by side;
// out (8, 384).
__global__ void probe_d(const __nv_bfloat16* x, float* out, int flat) {
  __shared__ float s_max[kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  s_max[c] = m;
  __syncthreads();
  for (int r = 0; r < kRows; ++r) out[r * kC4 + c] = s_max[c % kC];
}

// E: (1, 128) @ (128, 384), a 1-row left side and a wide result; out (8, 384).
__global__ void probe_e(const __nv_bfloat16* x, const float* wrep, float* out, int flat) {
  __shared__ float s_max[kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  s_max[c] = m;
  __syncthreads();
  float g = 0.f;
  for (int k = 0; k < 128; ++k) g = fmaf(s_max[k], wrep[k * kC4 + c], g);
  for (int r = 0; r < kRows; ++r) out[r * kC4 + c] = g;
}

// F: broadcast multiply, rows 0-7 of x * column sum; out (8, 384).
__global__ void probe_f(const __nv_bfloat16* x, float* out, int flat) {
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  for (int r = 0; r < kRows; ++r)
    out[r * kC4 + c] = __bfloat162float(x[static_cast<size_t>(r) * kC4 + c]) * s;
}

// G: per-group select: column c of the result takes x[r, p] for its group
// p = c / 96, built as four masked adds; out (8, 384).
__global__ void probe_g(const __nv_bfloat16* x, float* out) {
  const int c = threadIdx.x;
  for (int r = 0; r < kRows; ++r) {
    float acc = 0.f;
    for (int p = 0; p < 4; ++p) {
      const float gp = __bfloat162float(x[static_cast<size_t>(r) * kC4 + p]);
      acc += (c / kC == p) ? gp : 0.f;
    }
    out[r * kC4 + c] = acc;
  }
}

// H: the group max of C as four products with 0/1 selection matrices built
// from indices, the running max starting at 0; out (8, 128).
__global__ void probe_h(const __nv_bfloat16* x, float* out, int flat) {
  __shared__ float s_max[kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  s_max[c] = m;
  __syncthreads();
  if (c >= 128) return;
  float acc = 0.f;
  for (int p = 0; p < 4; ++p) {
    float dot = 0.f;
    for (int i = 0; i < kC4; ++i) {
      const float sel = (i == c + p * kC && c < kC) ? 1.f : 0.f;
      dot = fmaf(s_max[i], sel, dot);
    }
    acc = fmaxf(acc, dot);
  }
  for (int r = 0; r < kRows; ++r) out[r * 128 + c] = acc;
}

// I: a partial store into scratch: the first 128 columns of an (8, 384)
// shared buffer are written and read back, the rest is never touched;
// out (8, 128).
__global__ void probe_i(const __nv_bfloat16* x, float* out, int flat) {
  __shared__ float s_scratch[kRows][kC4];
  const int c = threadIdx.x;
  float s, m;
  column_reduce(x, flat, c, &s, &m);
  if (c < 128)
    for (int r = 0; r < kRows; ++r) s_scratch[r][c] = s;
  __syncthreads();
  if (c < 128)
    for (int r = 0; r < kRows; ++r) out[r * 128 + c] = s_scratch[r][c];
}

}  // namespace

// Probe `which` (0-9: A, B, B8, C, D, E, F, G, H, I) on x (flat, 384) bf16.
extern "C" int probe_op(int which, const void* x, const void* w, const void* wrep, void* out,
                        int flat, void* stream) {
  if (flat < 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* wr = static_cast<const float*>(wrep);
  float* o = static_cast<float*>(out);
  switch (which) {
    case 0: probe_a<<<1, kC4, 0, s>>>(xb, o, flat); break;
    case 1: probe_b<<<1, kC4, 0, s>>>(xb, wf, o, flat); break;
    case 2: probe_b8<<<1, kC4, 0, s>>>(xb, wf, o, flat); break;
    case 3: probe_c<<<1, kC4, 0, s>>>(xb, o, flat); break;
    case 4: probe_d<<<1, kC4, 0, s>>>(xb, o, flat); break;
    case 5: probe_e<<<1, kC4, 0, s>>>(xb, wr, o, flat); break;
    case 6: probe_f<<<1, kC4, 0, s>>>(xb, o, flat); break;
    case 7: probe_g<<<1, kC4, 0, s>>>(xb, o); break;
    case 8: probe_h<<<1, kC4, 0, s>>>(xb, o, flat); break;
    case 9: probe_i<<<1, kC4, 0, s>>>(xb, o, flat); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
