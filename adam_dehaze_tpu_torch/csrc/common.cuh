// Shared helpers of the port's CUDA kernels: element conversion between the
// storage types (float, bf16) and float, 16-byte vector loads of 8 elements,
// and the dynamic shared-memory opt-in above 48 KB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace adam {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Eight consecutive elements moved as 16-byte words. The pointer must be
// aligned to 8 elements (the wrappers check the base pointer; offsets are
// multiples of 8 elements).
template <typename T> struct Vec8;

template <> struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float v[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <> struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// Shared memory beyond 48 KB per block must be requested per kernel.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB, Hopper's per-block limit

}  // namespace adam
