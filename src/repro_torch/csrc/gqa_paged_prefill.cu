// K3: paged GQA chunked-prefill attention — a chunk of T queries per slot
// at positions prefix_len[b] + t, attending the cached prefix through the
// block table and the chunk's own raw K/V causally.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py:_gqa_prefill_kernel (entry
// gqa_paged_prefill, pallas_call at paged_attention.py:469), both branches:
// fp pools and int8 pools (quant=True, kv_quant).
//
//   q          f32 [B, T, Hkv, grp, Dh]
//   k_suf      S   [B, T, Hkv, Dh]       this chunk's raw keys (not read back
//   v_suf      S   [B, T, Hkv, Dv]       from the pool); S = f32 or bf16
//   k_pool     T   [NP, PS, Hkv, Dh]     T = S for fp pools, or int8
//   v_pool     T   [NP, PS, Hkv, Dv]
//   k_scale    f32 [NP, PS, Hkv]         int8 pools only (else null)
//   v_scale    f32 [NP, PS, Hkv]
//   table      i32 [B, P]
//   prefix_len i32 [B]                   tokens already in the pages
//   chunk_len  i32 [B]                   valid rows of this chunk (<= T)
//   out        f32 [B, T, Hkv, grp, Dv]
//
// Masks, as in the reference: a prefix key at position kv is valid when
// kv < prefix_len[b] (every chunk query postdates the prefix, so there is no
// causal term); a chunk key j is valid for query row t when j <= t and
// j < chunk_len[b].  Padded query rows (t >= chunk_len) are computed like the
// reference computes them; a row with no valid key gives zeros.
//
// Int8 pools, as the reference (paged_attention.py:364-368): only the
// prefix rows come from the int8 pool — their scores are scaled by
// k_scale[row] and their value weights (not the softmax sum) by
// v_scale[row]; the chunk's own suffix K/V stay raw fp (:370-384).
//
// What bounds it on an H100: at the main path's sizes (T up to a few hundred,
// Dh = 128) the score and value FLOPs, 2 * grp * (Dh + Dv) per (query, key)
// pair, on the CUDA cores (f32, 67 TFLOP/s) — this first kernel does not use
// the tensor cores.
//
// Design: one block per (tile of 16 query rows of the flattened T*grp axis,
// kv head, slot).  The block first streams the slot's live prefix pages
// (ceil(prefix_len / PS), dead table entries never read; int8 codes staged
// with 4-byte vector loads, the page's row scales beside them), then the
// chunk's
// suffix K/V in tiles of PS rows, skipping tiles wholly above the causal
// diagonal of its rows or past chunk_len.  Each tile's K/V rows are staged in
// shared memory; the online softmax state (m, l, acc) per query row lives in
// shared memory.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;  // query rows (of the flattened T*grp axis) per block

size_t smem_floats(int Dh, int Dv, int KT) {
  return (size_t)kRows * Dh          // q
         + (size_t)KT * (Dh + 1)     // K tile (padded rows)
         + (size_t)KT * (Dv + 1)     // V tile
         + 2 * (size_t)KT            // K, V row scales (int8 pools)
         + (size_t)kRows * KT        // scores / probabilities
         + (size_t)kRows * Dv        // acc
         + 3 * (size_t)kRows;        // m, l, correction
}

struct Smem {
  float *q, *k, *v, *ks, *vs, *p, *acc, *m, *l, *c;
};

// One online-softmax step over a staged [KT] key tile whose masked scores
// already sit in p (REPRO_NEG_INF where invalid).  With v_rows (int8 pages)
// the value weight of key r is exp * v_rows[r]; the sum l stays unscaled.
__device__ __forceinline__ void online_update(const Smem& s, int KT, int Dv,
                                              int ldv, const float* v_rows) {
  const int tid = threadIdx.x;
  for (int rr = tid; rr < kRows; rr += kThreads) {
    const float m_prev = s.m[rr];
    float m_new = m_prev;
    for (int r = 0; r < KT; ++r) m_new = fmaxf(m_new, s.p[rr * KT + r]);
    float sum = 0.f;
    for (int r = 0; r < KT; ++r) {
      const float sc = s.p[rr * KT + r];
      const float e = sc == REPRO_NEG_INF ? 0.f : expf(sc - m_new);
      sum += e;
      s.p[rr * KT + r] =
          v_rows != nullptr ? (sc == REPRO_NEG_INF ? 0.f : e * v_rows[r]) : e;
    }
    const float corr = expf(m_prev - m_new);
    s.l[rr] = s.l[rr] * corr + sum;
    s.m[rr] = m_new;
    s.c[rr] = corr;
  }
  __syncthreads();
  for (int i = tid; i < kRows * Dv; i += kThreads) {
    const int rr = i / Dv, d = i - rr * Dv;
    float a = s.acc[i] * s.c[rr];
    for (int r = 0; r < KT; ++r) a = fmaf(s.p[rr * KT + r], s.v[r * ldv + d], a);
    s.acc[i] = a;
  }
  __syncthreads();
}

template <typename ST, typename PT>
__global__ void __launch_bounds__(kThreads)
gqa_prefill_kernel(const float* __restrict__ q, const ST* __restrict__ k_suf,
                   const ST* __restrict__ v_suf, const PT* __restrict__ k_pool,
                   const PT* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ prefix_len,
                   const int* __restrict__ chunk_len, float* __restrict__ out,
                   int T, int Hkv, int grp, int Dh, int Dv, int PS, int P,
                   float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float smem[];
  const int KT = PS;
  const int ldk = Dh + 1, ldv = Dv + 1;
  Smem s;
  s.q = smem;
  s.k = s.q + kRows * Dh;
  s.v = s.k + KT * ldk;
  s.ks = s.v + KT * ldv;
  s.vs = s.ks + KT;
  s.p = s.vs + KT;
  s.acc = s.p + kRows * KT;
  s.m = s.acc + kRows * Dv;
  s.l = s.m + kRows;
  s.c = s.l + kRows;

  const int R0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nrows = min(kRows, T * grp - R0);

  for (int i = tid; i < kRows * Dh; i += kThreads) {
    const int rr = i / Dh, d = i - rr * Dh;
    float v = 0.f;
    if (rr < nrows) {
      const int R = R0 + rr, t = R / grp, g = R - t * grp;
      v = q[((((size_t)b * T + t) * Hkv + h) * grp + g) * Dh + d];
    }
    s.q[i] = v;
  }
  for (int i = tid; i < kRows * Dv; i += kThreads) s.acc[i] = 0.f;
  for (int i = tid; i < kRows; i += kThreads) {
    s.m[i] = REPRO_NEG_INF;
    s.l[i] = 0.f;
  }
  const int pfx = max(prefix_len[b], 0);
  const int cl = min(max(chunk_len[b], 0), T);
  const size_t k_row = (size_t)Hkv * Dh, v_row = (size_t)Hkv * Dv;
  __syncthreads();

  // phase 1: the cached prefix pages (kv < prefix_len, no causal term)
  const int n_pages = min((pfx + PS - 1) / PS, P);
  for (int pg = 0; pg < n_pages; ++pg) {
    const size_t page = (size_t)table[(size_t)b * P + pg];
    stage_tile<kThreads>(s.k, ldk,
                         k_pool + page * PS * k_row + (size_t)h * Dh, k_row,
                         KT, Dh);
    stage_tile<kThreads>(s.v, ldv,
                         v_pool + page * PS * v_row + (size_t)h * Dv, v_row,
                         KT, Dv);
    if (kQuant) {
      for (int r = tid; r < KT; r += kThreads) {
        s.ks[r] = k_scale[(page * PS + r) * Hkv + h];
        s.vs[r] = v_scale[(page * PS + r) * Hkv + h];
      }
    }
    __syncthreads();
    for (int i = tid; i < kRows * KT; i += kThreads) {
      const int rr = i / KT, r = i - rr * KT;
      float sc = REPRO_NEG_INF;
      if (rr < nrows && pg * PS + r < pfx) {
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d)
          dot = fmaf(s.q[rr * Dh + d], s.k[r * ldk + d], dot);
        sc = dot * scale;
        if (kQuant) sc *= s.ks[r];
      }
      s.p[i] = sc;
    }
    __syncthreads();
    online_update(s, KT, Dv, ldv, kQuant ? s.vs : nullptr);
  }

  // phase 2: the chunk's own raw K/V, causal within the chunk
  const int t_last = (R0 + nrows - 1) / grp;
  const int kv_end = min(t_last + 1, cl);
  const ST* kb = k_suf + (size_t)b * T * k_row + (size_t)h * Dh;
  const ST* vb = v_suf + (size_t)b * T * v_row + (size_t)h * Dv;
  for (int j0 = 0; j0 < kv_end; j0 += KT) {
    for (int i = tid; i < KT * Dh; i += kThreads) {
      const int r = i / Dh, d = i - r * Dh;
      s.k[r * ldk + d] = j0 + r < T ? to_f32(kb[(size_t)(j0 + r) * k_row + d]) : 0.f;
    }
    for (int i = tid; i < KT * Dv; i += kThreads) {
      const int r = i / Dv, d = i - r * Dv;
      s.v[r * ldv + d] = j0 + r < T ? to_f32(vb[(size_t)(j0 + r) * v_row + d]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kRows * KT; i += kThreads) {
      const int rr = i / KT, r = i - rr * KT;
      const int j = j0 + r;
      float sc = REPRO_NEG_INF;
      if (rr < nrows) {
        const int t = (R0 + rr) / grp;
        if (j <= t && j < cl) {
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d)
            dot = fmaf(s.q[rr * Dh + d], s.k[r * ldk + d], dot);
          sc = dot * scale;
        }
      }
      s.p[i] = sc;
    }
    __syncthreads();
    online_update(s, KT, Dv, ldv, nullptr);
  }

  for (int i = tid; i < nrows * Dv; i += kThreads) {
    const int rr = i / Dv, d = i - rr * Dv;
    const int R = R0 + rr, t = R / grp, g = R - t * grp;
    out[((((size_t)b * T + t) * Hkv + h) * grp + g) * Dv + d] =
        s.acc[i] / fmaxf(s.l[rr], 1e-30f);
  }
}

template <typename ST, typename PT>
cudaError_t launch(const float* q, const void* k_suf, const void* v_suf,
                   const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* prefix_len,
                   const int* chunk_len, float* out, int B, int T, int Hkv,
                   int grp, int Dh, int Dv, int PS, int P, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Dh, Dv, PS);
  cudaError_t err = reserve_smem(gqa_prefill_kernel<ST, PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T * grp + kRows - 1) / kRows, Hkv, B);
  gqa_prefill_kernel<ST, PT><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const ST*>(k_suf), static_cast<const ST*>(v_suf),
      static_cast<const PT*>(k_pool), static_cast<const PT*>(v_pool), k_scale,
      v_scale, table, prefix_len, chunk_len, out, T, Hkv, grp, Dh, Dv, PS, P,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gqa_paged_prefill(
    const void* q, const void* k_suf, const void* v_suf, int suf_dtype,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, int pool_dtype, const void* table,
    const void* prefix_len, const void* chunk_len, void* out, int B, int T,
    int Hkv, int grp, int Dh, int Dv, int PS, int P, float scale,
    void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* pl = static_cast<const int*>(prefix_len);
  const int* cl = static_cast<const int*>(chunk_len);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = pool_dtype == kI8;
  if (quant && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (suf_dtype == kF32 && pool_dtype == kF32)
    return launch<float, float>(qf, k_suf, v_suf, k_pool, v_pool, ks, vs, tb,
                                pl, cl, o, B, T, Hkv, grp, Dh, Dv, PS, P,
                                scale, s);
  if (suf_dtype == kBF16 && pool_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        qf, k_suf, v_suf, k_pool, v_pool, ks, vs, tb, pl, cl, o, B, T, Hkv,
        grp, Dh, Dv, PS, P, scale, s);
  if (suf_dtype == kF32 && quant)
    return launch<float, int8_t>(qf, k_suf, v_suf, k_pool, v_pool, ks, vs, tb,
                                 pl, cl, o, B, T, Hkv, grp, Dh, Dv, PS, P,
                                 scale, s);
  if (suf_dtype == kBF16 && quant)
    return launch<__nv_bfloat16, int8_t>(
        qf, k_suf, v_suf, k_pool, v_pool, ks, vs, tb, pl, cl, o, B, T, Hkv,
        grp, Dh, Dv, PS, P, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
