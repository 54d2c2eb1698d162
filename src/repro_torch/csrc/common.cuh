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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 4-byte asynchronous copy; `n` < size bytes are read, the rest of
// the destination is zero-filled (n = 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kPending committed copy groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// ---------------------------------------------------------------------------
// Absorbed MLA attention tiles: the shared body of B8 (mla_paged_decode.cu)
// and B9 (mla_paged_prefill.cu).  A block holds NR query rows (q_lat [NR, r]
// and q_pe [NR, dr], f32) and streams key tiles of KT latent rows (ckv
// [KT, r], kpe [KT, dr]) through shared memory; every query row of the block
// scores every staged key row, so a tile is read from device memory once
// per block, not once per head.  The online softmax state (m, l) and the
// [NR, r] latent accumulator live in shared memory.  r and dr are runtime
// values (any width: 512/64 at full width, 16/8 in the smoke config); rows
// are padded by one float so that a thread's dot product over a row and
// its neighbours' over neighbouring rows fall in different banks.
namespace mla {

struct Tile {
  float *q, *qpe;    // [NR, r+1], [NR, dr+1]
  float *ckv, *kpe;  // [KT, r+1], [KT, dr+1]
  float *cs, *ps;    // [KT] int8 row scales of ckv / kpe (1 for fp rows)
  float *p;          // [NR, KT] scores, then value weights
  float *acc;        // [NR, r]
  float *m, *l, *c;  // [NR] running max, sum, correction
};

inline size_t smem_floats(int NR, int KT, int r, int dr) {
  return (size_t)NR * (r + 1) + (size_t)NR * (dr + 1) +
         (size_t)KT * (r + 1) + (size_t)KT * (dr + 1) + 2 * (size_t)KT +
         (size_t)NR * KT + (size_t)NR * r + 3 * (size_t)NR;
}

__device__ __forceinline__ Tile carve(float* smem, int NR, int KT, int r,
                                      int dr) {
  Tile s;
  s.q = smem;
  s.qpe = s.q + NR * (r + 1);
  s.ckv = s.qpe + NR * (dr + 1);
  s.kpe = s.ckv + KT * (r + 1);
  s.cs = s.kpe + KT * (dr + 1);
  s.ps = s.cs + KT;
  s.p = s.ps + KT;
  s.acc = s.p + NR * KT;
  s.m = s.acc + NR * r;
  s.l = s.m + NR;
  s.c = s.l + NR;
  return s;
}

// Load query rows: row rr < nrows of the block is row (row0 + rr) of the
// [*, r] / [*, dr] query arrays; rows past nrows are zero.  Zeroes acc and
// sets m = -inf, l = 0.
template <int kThreads>
__device__ __forceinline__ void load_queries(
    const Tile& s, const float* __restrict__ q_lat,
    const float* __restrict__ q_pe, size_t row0, int nrows, int NR, int r,
    int dr) {
  for (int i = threadIdx.x; i < NR * r; i += kThreads) {
    const int rr = i / r, d = i - rr * r;
    s.q[rr * (r + 1) + d] = rr < nrows ? q_lat[(row0 + rr) * r + d] : 0.f;
    s.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < NR * dr; i += kThreads) {
    const int rr = i / dr, d = i - rr * dr;
    s.qpe[rr * (dr + 1) + d] = rr < nrows ? q_pe[(row0 + rr) * dr + d] : 0.f;
  }
  for (int i = threadIdx.x; i < NR; i += kThreads) {
    s.m[i] = REPRO_NEG_INF;
    s.l[i] = 0.f;
  }
}

// Stage `rows` (<= KT) consecutive latent rows (ckv row stride r, kpe row
// stride dr) into the key tile, the rest of the tile zero; with `cs`/`ps`
// (int8 pools) the rows' scales beside them, else scales 1.
template <int kThreads, typename T>
__device__ __forceinline__ void stage_keys(const Tile& s,
                                           const T* __restrict__ ckv,
                                           const T* __restrict__ kpe,
                                           const float* __restrict__ cs,
                                           const float* __restrict__ ps,
                                           int rows, int KT, int r, int dr) {
  stage_tile<kThreads>(s.ckv, r + 1, ckv, (size_t)r, rows, r);
  stage_tile<kThreads>(s.kpe, dr + 1, kpe, (size_t)dr, rows, dr);
  for (int i = threadIdx.x + rows * r; i < KT * r; i += kThreads) {
    const int k = i / r;
    s.ckv[k * (r + 1) + (i - k * r)] = 0.f;
  }
  for (int i = threadIdx.x + rows * dr; i < KT * dr; i += kThreads) {
    const int k = i / dr;
    s.kpe[k * (dr + 1) + (i - k * dr)] = 0.f;
  }
  for (int k = threadIdx.x; k < KT; k += kThreads) {
    s.cs[k] = cs != nullptr && k < rows ? cs[k] : 1.f;
    s.ps[k] = ps != nullptr && k < rows ? ps[k] : 1.f;
  }
}

// Score every (query row, key row) pair of the staged tile:
//   s = (q_lat . ckv * cs + q_pe . kpe * ps) * scale
// (the reference's order), or REPRO_NEG_INF where valid(rr, k) is false.
template <int kThreads, typename Valid>
__device__ __forceinline__ void score(const Tile& s, int NR, int KT, int r,
                                      int dr, float scale, Valid valid) {
  for (int i = threadIdx.x; i < NR * KT; i += kThreads) {
    const int rr = i / KT, k = i - rr * KT;
    float sc = REPRO_NEG_INF;
    if (valid(rr, k)) {
      const float* q = s.q + rr * (r + 1);
      const float* c = s.ckv + k * (r + 1);
      float a = 0.f, b = 0.f;
      for (int d = 0; d < r; ++d) a = fmaf(q[d], c[d], a);
      const float* qp = s.qpe + rr * (dr + 1);
      const float* kp = s.kpe + k * (dr + 1);
      for (int d = 0; d < dr; ++d) b = fmaf(qp[d], kp[d], b);
      sc = (a * s.cs[k] + b * s.ps[k]) * scale;
    }
    s.p[i] = sc;
  }
  __syncthreads();
}

// One online-softmax step over the scored tile.  Masked keys contribute
// exactly 0; the sum l takes the unscaled exp and the value weights carry
// the ckv row scale (o = sum_j p_j * cs_j * ckv_j).  Ends synchronised.
template <int kThreads>
__device__ __forceinline__ void update(const Tile& s, int NR, int KT, int r) {
  for (int rr = threadIdx.x; rr < NR; rr += kThreads) {
    const float m_prev = s.m[rr];
    float m_new = m_prev;
    for (int k = 0; k < KT; ++k) m_new = fmaxf(m_new, s.p[rr * KT + k]);
    float sum = 0.f;
    for (int k = 0; k < KT; ++k) {
      const float sc = s.p[rr * KT + k];
      const float e = sc == REPRO_NEG_INF ? 0.f : expf(sc - m_new);
      sum += e;
      s.p[rr * KT + k] = e * s.cs[k];
    }
    const float corr = expf(m_prev - m_new);
    s.l[rr] = s.l[rr] * corr + sum;
    s.m[rr] = m_new;
    s.c[rr] = corr;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NR * r; i += kThreads) {
    const int rr = i / r, d = i - rr * r;
    float a = s.acc[i] * s.c[rr];
    const float* pw = s.p + rr * KT;
    for (int k = 0; k < KT; ++k) a = fmaf(pw[k], s.ckv[k * (r + 1) + d], a);
    s.acc[i] = a;
  }
  __syncthreads();
}

// o = acc / max(l, 1e-30) for the block's first nrows rows, written to row
// (row0 + rr) of the [*, r] output.
template <int kThreads>
__device__ __forceinline__ void store(const Tile& s, float* __restrict__ out,
                                      size_t row0, int nrows, int r) {
  for (int i = threadIdx.x; i < nrows * r; i += kThreads) {
    const int rr = i / r;
    out[(row0 + rr) * r + (i - rr * r)] = s.acc[i] / fmaxf(s.l[rr], 1e-30f);
  }
}

}  // namespace mla
