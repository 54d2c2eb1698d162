// Shared helpers for the port's hand-written sm_90a kernels.
//
// Every kernel library exposes a plain C interface (no PyTorch headers, so
// nvcc builds it in seconds) that launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() for the Python wrapper to check.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// element-type codes shared with the ctypes wrappers (kernels/_build.py)
enum ReproDtype { kF32 = 0, kBF16 = 1 };

// the reference kernels' masked-score value (kernels/paged_attention.py)
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
// Returns cudaSuccess or the error; the launch that follows reports the rest.
template <typename Kernel>
static cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
