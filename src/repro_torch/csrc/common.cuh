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
enum ReproDtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

// the reference kernels' masked-score value (kernels/paged_attention.py)
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage a [rows, cols] tile of a K/V pool page (row stride `stride`
// elements) into shared f32 rows of leading dimension `ld`, converting each
// element.  All kThreads threads of the block take part; the thread count
// is a compile-time constant so the loop keeps many loads in flight.
template <int kThreads, typename PT>
struct TileStager {
  __device__ __forceinline__ static void run(float* __restrict__ dst, int ld,
                                             const PT* __restrict__ src,
                                             size_t stride, int rows,
                                             int cols) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, d = i - r * cols;
      dst[r * ld + d] = to_f32(src[r * stride + d]);
    }
  }
};

// int8 codes: one 4-byte vector load (4 codes) per thread and step.  Needs
// cols % 4 == 0 and 4-byte aligned rows (the wrappers check Dh % 4 == 0 and
// the pool's alignment).
template <int kThreads>
struct TileStager<kThreads, int8_t> {
  __device__ __forceinline__ static void run(float* __restrict__ dst, int ld,
                                             const int8_t* __restrict__ src,
                                             size_t stride, int rows,
                                             int cols) {
    const int wpr = cols / 4;
    for (int i = threadIdx.x; i < rows * wpr; i += kThreads) {
      const int r = i / wpr, w = i - r * wpr;
      const char4 c =
          __ldg(reinterpret_cast<const char4*>(src + r * stride + 4 * w));
      float* o = dst + r * ld + 4 * w;
      o[0] = static_cast<float>(c.x);
      o[1] = static_cast<float>(c.y);
      o[2] = static_cast<float>(c.z);
      o[3] = static_cast<float>(c.w);
    }
  }
};

template <int kThreads, typename PT>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const PT* src,
                                           size_t stride, int rows,
                                           int cols) {
  TileStager<kThreads, PT>::run(dst, ld, src, stride, rows, cols);
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
