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
// j < chunk_len[b].  Masked scores take -1e30 and contribute exactly 0;
// padded query rows (t >= chunk_len) are computed as the reference computes
// them; a row with no valid key gives zeros (acc / max(l, 1e-30)).
//
// Int8 pools, as the reference (paged_attention.py:364-368): only the
// prefix rows come from the int8 pool — their scores are scaled by
// k_scale[row] and their value weights (not the softmax sum) by
// v_scale[row]; the chunk's own suffix K/V stay raw fp (:370-384).
//
// What bounds it on an H100: at the main path's sizes (T up to a few
// hundred, Dh = 128) the score and value products, 2 * grp * (Dh + Dv)
// operations per (query, key) pair — on the tensor cores here.
//
// Design (the tensor-core path): the tile of attn_tile.cuh (shared with
// B4).  One block per (64 query rows of the flattened T*grp axis, kv head
// and slice of <= kDV value columns, slot), 4 warps of 16 rows; the grp
// heads of one KV head share every K/V tile.  The prefix phase gathers each
// 64-key tile's rows through the table one row at a time, so a tile may
// span any number of pages (PS need not divide 64) and rows at or past
// prefix_len are zero-filled, never read; the suffix phase takes a
// contiguous slice of k_suf/v_suf.  Tiles wholly past chunk_len or above a
// warp's causal diagonal are skipped, the diagonal tile is masked.  Where
// one ring stage does not fit (f32 rows of several hundred), the block
// takes the CUDA-core path below.
//
// Arithmetic (attn_tile.cuh): (f32 suffix, f32 pools) is 3xTF32 in both
// phases, (bf16, bf16) three exact bf16 terms of the f32 operand (Q, or P)
// in both, and with int8 pools the prefix phase is bf16x3 on the codes (the
// scales applied to the f32 scores and to P in f32) while the suffix phase
// follows the suffix's type.  P V sums each 32 keys in a fresh accumulator,
// added to the output's in f32: the MMAs truncate their sums towards 0, and
// one accumulator carried over a 2048-token prefix (864 3xTF32 MMAs) drifts
// past the 1e-5 tolerance, with bf16 terms past 4096 tokens.
//
// The CUDA-core path (widths whose tile does not fit in shared memory): one
// block per (16 query rows, kv head, slot) streams PS-row tiles through
// shared memory as f32 and runs each score and value product as one
// thread's f32 loop.

#include <algorithm>
#include <type_traits>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn_tc;

template <typename ST, typename PT, int kDV>
__global__ void __launch_bounds__(kThreads)
prefill_tc_kernel(const float* __restrict__ q, const ST* __restrict__ k_suf,
                  const ST* __restrict__ v_suf, const PT* __restrict__ k_pool,
                  const PT* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ table,
                  const int* __restrict__ prefix_len,
                  const int* __restrict__ chunk_len, float* __restrict__ out,
                  const Geo G) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int kNT = kDV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R0 = blockIdx.x * kRows;
  const int h = blockIdx.y / G.n_vs;
  const int v0 = (blockIdx.y - h * G.n_vs) * kDV;
  const int b = blockIdx.z;
  const int TG = G.T * G.grp;
  const int nrows = min(kRows, TG - R0);
  const int vw = min(kDV, G.Dv - v0);
  const int pfx = min(max(prefix_len[b], 0), G.P * G.PS);
  const int cl = min(max(chunk_len[b], 0), G.T);
  const int kv_end = min((R0 + nrows - 1) / G.grp + 1, cl);
  const int n_pt = (pfx + kKeys - 1) / kKeys;
  const int n_tiles = n_pt + (kv_end + kKeys - 1) / kKeys;
  const size_t k_row = (size_t)G.Hkv * G.Dh, v_row = (size_t)G.Hkv * G.Dv;
  const int ldq = G.Dhp + 4;
  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (size_t)kRows * ldq * 4;

  stage_rows(smem, ldq * 4, kRows, G.Dh * 4, G.Dhp * 4, G.pq, q,
             [&](int r) -> const unsigned char* {
               const int R = R0 + r;
               if (R >= TG) return nullptr;
               const int t = R / G.grp;
               return reinterpret_cast<const unsigned char*>(
                   q + (((size_t)b * G.T + t) * G.Hkv + h) * G.grp * G.Dh +
                   (size_t)(R - t * G.grp) * G.Dh);
             });

  // stage key tile i (prefix tiles first) into ring stage st
  auto issue = [&](int i, int st) {
    unsigned char* kd = ring + (size_t)st * G.stage_bytes;
    unsigned char* vd = kd + kKeys * G.ldk;
    if (i < n_pt) {
      const int j0 = i * kKeys;
      const int* tb = table + (size_t)b * G.P;
      auto pos = [&](int r) -> long long {
        const int kv = j0 + r;
        if (kv >= pfx) return -1;
        return (long long)tb[kv / G.PS] * G.PS + kv % G.PS;
      };
      stage_rows(kd, G.ldk, kKeys, G.Dh * (int)sizeof(PT),
                 G.Dhp * (int)sizeof(PT), G.pkp, k_pool,
                 [&](int r) -> const unsigned char* {
                   const long long p = pos(r);
                   return p < 0 ? nullptr
                                : reinterpret_cast<const unsigned char*>(
                                      k_pool + p * k_row + (size_t)h * G.Dh);
                 });
      stage_rows(vd, G.ldv, kKeys, vw * (int)sizeof(PT),
                 kDV * (int)sizeof(PT), G.pvp, v_pool,
                 [&](int r) -> const unsigned char* {
                   const long long p = pos(r);
                   return p < 0 ? nullptr
                                : reinterpret_cast<const unsigned char*>(
                                      v_pool + p * v_row + (size_t)h * G.Dv +
                                      v0);
                 });
      if (kQuant) {
        unsigned char* sd = vd + kKeys * G.ldv;
        stage_rows(sd, 4, kKeys, 4, 4, 4, k_scale,
                   [&](int r) -> const unsigned char* {
                     const long long p = pos(r);
                     return p < 0 ? nullptr
                                  : reinterpret_cast<const unsigned char*>(
                                        k_scale + p * G.Hkv + h);
                   });
        stage_rows(sd + 4 * kKeys, 4, kKeys, 4, 4, 4, v_scale,
                   [&](int r) -> const unsigned char* {
                     const long long p = pos(r);
                     return p < 0 ? nullptr
                                  : reinterpret_cast<const unsigned char*>(
                                        v_scale + p * G.Hkv + h);
                   });
      }
    } else {
      const int j0 = (i - n_pt) * kKeys;
      const size_t row0 = (size_t)b * G.T;
      stage_rows(kd, G.ldk, kKeys, G.Dh * (int)sizeof(ST),
                 G.Dhp * (int)sizeof(ST), G.pks, k_suf,
                 [&](int r) -> const unsigned char* {
                   const int j = j0 + r;
                   return j >= kv_end ? nullptr
                                      : reinterpret_cast<const unsigned char*>(
                                            k_suf + (row0 + j) * k_row +
                                            (size_t)h * G.Dh);
                 });
      stage_rows(vd, G.ldv, kKeys, vw * (int)sizeof(ST),
                 kDV * (int)sizeof(ST), G.pvs, v_suf,
                 [&](int r) -> const unsigned char* {
                   const int j = j0 + r;
                   return j >= kv_end ? nullptr
                                      : reinterpret_cast<const unsigned char*>(
                                            v_suf + (row0 + j) * v_row +
                                            (size_t)h * G.Dv + v0);
                 });
    }
  };

  if (n_tiles > 0) issue(0, 0);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 16 * warp;                        // the warp's first row
  const int ta = (R0 + wr + g) / G.grp;            // chunk position of row g
  const int tb = (R0 + wr + g + 8) / G.grp;        // and of row g + 8
  const int t_warp = (R0 + wr + 15) / G.grp;       // of the warp's last row
  const float* qw = qs + wr * ldq;
  float o[kNT][4], m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lp[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = G.stages == 2 ? (i & 1) : 0;
    if (G.stages == 2) {
      if (i + 1 < n_tiles) issue(i + 1, (i + 1) & 1);
      cp_commit();
      cp_wait<1>();          // tile i (and Q) landed: this thread's copies
    } else {
      cp_wait<0>();
    }
    __syncthreads();         // everyone's copies
    const unsigned char* kd = ring + (size_t)st * G.stage_bytes;
    const unsigned char* vd = kd + kKeys * G.ldk;
    const float* sc = reinterpret_cast<const float*>(vd + kKeys * G.ldv);
    if (i < n_pt) {
      tile_step<PT, true, kQuant, kNT>(o, m, lp, qw, ldq, kd, vd, sc,
                                       sc + kKeys, G, i * kKeys, pfx, ta, tb,
                                       g, tq);
    } else {
      const int j0 = (i - n_pt) * kKeys;
      if (j0 <= t_warp)      // else every key is above this warp's diagonal
        tile_step<ST, false, false, kNT>(o, m, lp, qw, ldq, kd, vd, sc, sc,
                                         G, j0, cl, ta, tb, g, tq);
    }
    __syncthreads();         // the stage is free for the next copies
    if (G.stages == 1 && i + 1 < n_tiles) {
      issue(i + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lp[r] + __shfl_xor_sync(0xffffffffu, lp[r], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int rr = wr + g + 8 * r;
    if (rr >= nrows) continue;
    const int R = R0 + rr, t = R / G.grp;
    float* orow = out + (((size_t)b * G.T + t) * G.Hkv + h) * G.grp * G.Dv +
                  (size_t)(R - t * G.grp) * G.Dv + v0;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int c = 8 * n + 2 * tq;
      if (c < vw) orow[c] = o[n][2 * r] / den;
      if (c + 1 < vw) orow[c + 1] = o[n][2 * r + 1] / den;
    }
  }
}

// ------------------------------------------------------- CUDA-core path
constexpr int kSimtRows = 16;  // query rows per block

size_t simt_smem_floats(int Dh, int Dv, int KT) {
  return (size_t)kSimtRows * Dh      // q
         + (size_t)KT * (Dh + 1)     // K tile (padded rows)
         + (size_t)KT * (Dv + 1)     // V tile
         + 2 * (size_t)KT            // K, V row scales (int8 pools)
         + (size_t)kSimtRows * KT    // scores / probabilities
         + (size_t)kSimtRows * Dv    // acc
         + 3 * (size_t)kSimtRows;    // m, l, correction
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
  for (int rr = tid; rr < kSimtRows; rr += kThreads) {
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
  for (int i = tid; i < kSimtRows * Dv; i += kThreads) {
    const int rr = i / Dv, d = i - rr * Dv;
    float a = s.acc[i] * s.c[rr];
    for (int r = 0; r < KT; ++r) a = fmaf(s.p[rr * KT + r], s.v[r * ldv + d], a);
    s.acc[i] = a;
  }
  __syncthreads();
}

template <typename ST, typename PT>
__global__ void __launch_bounds__(kThreads)
prefill_simt_kernel(const float* __restrict__ q, const ST* __restrict__ k_suf,
                    const ST* __restrict__ v_suf,
                    const PT* __restrict__ k_pool,
                    const PT* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ prefix_len,
                    const int* __restrict__ chunk_len, float* __restrict__ out,
                    int T, int Hkv, int grp, int Dh, int Dv, int PS, int P,
                    float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float smem_f[];
  const int KT = PS;
  const int ldk = Dh + 1, ldv = Dv + 1;
  Smem s;
  s.q = smem_f;
  s.k = s.q + kSimtRows * Dh;
  s.v = s.k + KT * ldk;
  s.ks = s.v + KT * ldv;
  s.vs = s.ks + KT;
  s.p = s.vs + KT;
  s.acc = s.p + kSimtRows * KT;
  s.m = s.acc + kSimtRows * Dv;
  s.l = s.m + kSimtRows;
  s.c = s.l + kSimtRows;

  const int R0 = blockIdx.x * kSimtRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nrows = min(kSimtRows, T * grp - R0);

  for (int i = tid; i < kSimtRows * Dh; i += kThreads) {
    const int rr = i / Dh, d = i - rr * Dh;
    float v = 0.f;
    if (rr < nrows) {
      const int R = R0 + rr, t = R / grp, g = R - t * grp;
      v = q[((((size_t)b * T + t) * Hkv + h) * grp + g) * Dh + d];
    }
    s.q[i] = v;
  }
  for (int i = tid; i < kSimtRows * Dv; i += kThreads) s.acc[i] = 0.f;
  for (int i = tid; i < kSimtRows; i += kThreads) {
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
    for (int i = tid; i < kSimtRows * KT; i += kThreads) {
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
    for (int i = tid; i < kSimtRows * KT; i += kThreads) {
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

// ----------------------------------------------------------------- launch
template <typename ST, typename PT, int kDV>
cudaError_t launch_tc(const float* q, const ST* k_suf, const ST* v_suf,
                      const PT* k_pool, const PT* v_pool,
                      const float* k_scale, const float* v_scale,
                      const int* table, const int* prefix_len,
                      const int* chunk_len, float* out, int B, Geo G,
                      size_t q_bytes, cudaStream_t stream) {
  const size_t smem = q_bytes + (size_t)G.stages * G.stage_bytes;
  cudaError_t err = reserve_smem(prefill_tc_kernel<ST, PT, kDV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((G.T * G.grp + kRows - 1) / kRows, G.Hkv * G.n_vs, B);
  prefill_tc_kernel<ST, PT, kDV><<<grid, kThreads, smem, stream>>>(
      q, k_suf, v_suf, k_pool, v_pool, k_scale, v_scale, table, prefix_len,
      chunk_len, out, G);
  return cudaGetLastError();
}

template <typename ST, typename PT>
cudaError_t launch(const float* q, const void* k_suf_v, const void* v_suf_v,
                   const void* k_pool_v, const void* v_pool_v,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* prefix_len,
                   const int* chunk_len, float* out, int B, int T, int Hkv,
                   int grp, int Dh, int Dv, int PS, int P, float scale,
                   cudaStream_t stream) {
  const ST* k_suf = static_cast<const ST*>(k_suf_v);
  const ST* v_suf = static_cast<const ST*>(v_suf_v);
  const PT* k_pool = static_cast<const PT*>(k_pool_v);
  const PT* v_pool = static_cast<const PT*>(v_pool_v);
  const bool quant = std::is_same<PT, int8_t>::value;
  const int kdv = Dv <= 64 ? 64 : 128;
  const size_t es = std::max(sizeof(ST), sizeof(PT));
  Geo G;
  G.T = T;
  G.Hkv = Hkv;
  G.grp = grp;
  G.Dh = Dh;
  G.Dv = Dv;
  G.PS = PS;
  G.P = P;
  G.Dhp = (Dh + 15) / 16 * 16;
  G.n_vs = (Dv + kdv - 1) / kdv;
  G.ldk = (int)(G.Dhp * es + 16);
  G.ldv = (int)(kdv * es + 16);
  G.stage_bytes = kKeys * (G.ldk + G.ldv) + (quant ? 2 * kKeys * 4 : 0);
  G.pq = piece_for(q, (size_t)Dh * 4, 4);
  G.pkp = piece_for(k_pool, (size_t)Dh * sizeof(PT), sizeof(PT));
  G.pvp = piece_for(v_pool, (size_t)Dv * sizeof(PT), sizeof(PT));
  G.pks = piece_for(k_suf, (size_t)Dh * sizeof(ST), sizeof(ST));
  G.pvs = piece_for(v_suf, (size_t)Dv * sizeof(ST), sizeof(ST));
  G.scale = scale;
  const size_t q_bytes = (size_t)kRows * (G.Dhp + 4) * 4;
  G.stages = ring_stages(q_bytes, G.stage_bytes);
  if (G.stages > 0) {
    if (kdv == 64)
      return launch_tc<ST, PT, 64>(q, k_suf, v_suf, k_pool, v_pool, k_scale,
                                   v_scale, table, prefix_len, chunk_len, out,
                                   B, G, q_bytes, stream);
    return launch_tc<ST, PT, 128>(q, k_suf, v_suf, k_pool, v_pool, k_scale,
                                  v_scale, table, prefix_len, chunk_len, out,
                                  B, G, q_bytes, stream);
  }
  const size_t smem = sizeof(float) * simt_smem_floats(Dh, Dv, PS);
  cudaError_t err = reserve_smem(prefill_simt_kernel<ST, PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T * grp + kSimtRows - 1) / kSimtRows, Hkv, B);
  prefill_simt_kernel<ST, PT><<<grid, kThreads, smem, stream>>>(
      q, k_suf, v_suf, k_pool, v_pool, k_scale, v_scale, table, prefix_len,
      chunk_len, out, T, Hkv, grp, Dh, Dv, PS, P, scale);
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
