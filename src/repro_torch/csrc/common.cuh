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

// ---------------------------------------------------------------------------
// Group-wise int4 GEMM tile with per-token int8 activations: the body of B5
// (w4a8_matmul.cu), shared with its grouped (stacked-expert) form B7
// (w4a8_grouped.cu).  One call computes the [kTTile tokens, kBlockCo
// columns] output tile (t_blk, col_blk) of Y[T, Co] = X[T, Ci] @ W[Ci, Co];
// the kernels pick the tile from blockIdx and, in the grouped form, offset
// every operand to one expert first.  Each source's header says how the
// tile is laid out and what bounds it on the card.  (The W4A16 tile of K1
// and B6 is w4a16_tile.cuh.)
namespace w4 {

constexpr int kColsPerThread = 4;
constexpr int kColLanes = 16;
constexpr int kBlockCo = kColLanes * kColsPerThread;  // 64 columns per block
constexpr int kSplits = 8;
constexpr int kTTile = 8;
constexpr int kThreads = kColLanes * kSplits;          // 128

inline size_t a8_smem_bytes(int G) {
  return (size_t)kSplits * kTTile * G                          // int8 X codes
         + sizeof(float) * (size_t)kSplits * kTTile * kBlockCo;  // reduction
}

__device__ __forceinline__ uint32_t splat(int v) {
  return (uint32_t)(uint8_t)(int8_t)v * 0x01010101u;
}

// int8 zero-point fold of 4 codes in [0, 15]: clip(code - z, -128, 127),
// with z split into two int8 steps z1 + z2 (both clamped) so the signed
// saturation of each step reproduces the single clip exactly.
__device__ __forceinline__ uint32_t fold(uint32_t codes, uint32_t z1,
                                         uint32_t z2) {
  return __vsubss4(__vsubss4(codes, z1), z2);
}

template <typename ST, typename YT>
__device__ __forceinline__ void a8_tile(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
    const ST* __restrict__ zeros, YT* __restrict__ y, int T, int Ci, int Co,
    int G, int col_blk, int t_blk, unsigned char* __restrict__ smem_raw) {
  const int lane = threadIdx.x % kColLanes;
  const int ks = threadIdx.x / kColLanes;
  const int wpr = G / 4;  // 32-bit words per staged activation row
  int* xw = reinterpret_cast<int*>(smem_raw) + (size_t)ks * kTTile * wpr;
  float* red = reinterpret_cast<float*>(
      smem_raw + (size_t)kSplits * kTTile * G);  // [kSplits][kTTile][kBlockCo]

  const int col0 = col_blk * kBlockCo + lane * kColsPerThread;
  const int t0 = t_blk * kTTile;
  const bool col_ok = col0 < Co;
  const int n_groups = Ci / G;
  const int half = G / 2;

  float acc[kTTile][kColsPerThread];
#pragma unroll
  for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[tt][j] = 0.f;

  for (int round = 0; round < n_groups; round += kSplits) {
    const int g = round + ks;
    __syncthreads();  // the previous round's reads of xw are finished
    if (g < n_groups) {
      for (int i = lane; i < kTTile * wpr; i += kColLanes) {
        const int tt = i / wpr, w = i - tt * wpr;
        const int t = t0 + tt;
        xw[i] = t < T ? __ldg(reinterpret_cast<const int*>(
                            xq + (size_t)t * Ci + (size_t)g * G) + w)
                      : 0;
      }
    }
    __syncthreads();
    if (g < n_groups && col_ok) {
      float sc[kColsPerThread];
      uint32_t z1[kColsPerThread], z2[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        sc[j] = to_f32(scales[(size_t)g * Co + col0 + j]);
        const float z = rintf(to_f32(zeros[(size_t)g * Co + col0 + j]));
        const float a = fminf(fmaxf(z, -128.f), 127.f);
        const float b = fminf(fmaxf(z - a, -128.f), 127.f);
        z1[j] = splat((int)a);
        z2[j] = splat((int)b);
      }
      int part[kTTile][kColsPerThread];
#pragma unroll
      for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) part[tt][j] = 0;
      const uint8_t* prow = packed + (size_t)g * half * Co + col0;
#pragma unroll 2
      for (int r = 0; r < half; r += 4) {
        const uint32_t w0 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)r * Co));
        const uint32_t w1 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)(r + 1) * Co));
        const uint32_t w2 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)(r + 2) * Co));
        const uint32_t w3 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)(r + 3) * Co));
        // 4x4 byte transpose: col[j] = byte j of w0..w3 (rows r..r+3)
        const uint32_t t01a = __byte_perm(w0, w1, 0x5140);
        const uint32_t t01b = __byte_perm(w0, w1, 0x7362);
        const uint32_t t23a = __byte_perm(w2, w3, 0x5140);
        const uint32_t t23b = __byte_perm(w2, w3, 0x7362);
        uint32_t col[kColsPerThread];
        col[0] = __byte_perm(t01a, t23a, 0x5410);
        col[1] = __byte_perm(t01a, t23a, 0x7632);
        col[2] = __byte_perm(t01b, t23b, 0x5410);
        col[3] = __byte_perm(t01b, t23b, 0x7632);
        int lo[kColsPerThread], hi[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          lo[j] = (int)fold(col[j] & 0x0F0F0F0Fu, z1[j], z2[j]);
          hi[j] = (int)fold((col[j] >> 4) & 0x0F0F0F0Fu, z1[j], z2[j]);
        }
#pragma unroll
        for (int tt = 0; tt < kTTile; ++tt) {
          const int xl = xw[tt * wpr + r / 4];
          const int xh = xw[tt * wpr + (half + r) / 4];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            part[tt][j] = __dp4a(xl, lo[j], part[tt][j]);
            part[tt][j] = __dp4a(xh, hi[j], part[tt][j]);
          }
        }
      }
      // the group's exact int32 sums leave integer space here, scaled by
      // the group's weight scale (|part| < 2^24, so the f32 cast is exact)
#pragma unroll
      for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[tt][j] += static_cast<float>(part[tt][j]) * sc[j];
    }
  }

#pragma unroll
  for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      red[((size_t)ks * kTTile + tt) * kBlockCo + lane * kColsPerThread + j] =
          acc[tt][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kTTile * kBlockCo; i += kThreads) {
    const int tt = i / kBlockCo, c = i - tt * kBlockCo;
    const int t = t0 + tt, col = col_blk * kBlockCo + c;
    if (t < T && col < Co) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kSplits; ++k)
        s += red[((size_t)k * kTTile + tt) * kBlockCo + c];
      store_as(&y[(size_t)t * Co + col], s * xs[t]);
    }
  }
}

}  // namespace w4

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
