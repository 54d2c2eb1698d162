// B9: absorbed Multi-head Latent Attention (MLA) chunked prefill — a chunk
// of T tokens per slot at positions prefix_len[b] + t, every one of its T*H
// query rows attending the cached latent prefix through the block table and
// the chunk's own raw latents causally.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention.py:_mla_prefill_kernel (entry
// mla_paged_prefill, pallas_call at paged_attention.py:633), both branches:
// fp pools and int8 pools (quant=True, kv_quant).
//
//   q_lat      f32 [B, T, H, r]   absorbed chunk queries
//   q_pe       f32 [B, T, H, dr]
//   ckv_suf    S   [B, T, r]      the chunk's raw latents (not read back from
//   kpe_suf    S   [B, T, dr]     the pool); S = f32 or bf16
//   ckv_pool   T   [NP, PS, r]    T = S for fp pools, or int8
//   kpe_pool   T   [NP, PS, dr]
//   ckv_s      f32 [NP, PS]       int8 pools only (else null): row scales
//   kpe_s      f32 [NP, PS]
//   table      i32 [B, P]
//   prefix_len i32 [B]            tokens already in the pages
//   chunk_len  i32 [B]            valid rows of this chunk (<= T)
//   out        f32 [B, T, H, r]   latent output o_lat
//
// Masks, as in the reference: the (t, h) query rows are flattened to
// row = t*H + h; a cached row at position kv is valid when kv < prefix_len[b]
// (every chunk query postdates the prefix); a chunk row j is valid for query
// row `row` when j <= row / H and j < chunk_len[b].  Padding rows
// (t >= chunk_len) attend the valid chunk rows and give finite output that
// nothing reads; a row with no valid key gives zeros.  Scores and weights as
// in B8 (mla_paged_decode.cu): int8 row scales apply to the prefix rows only,
// the chunk's own latents stay raw fp.
//
// What bounds it on an H100: the score and value products, (r + dr + r)
// multiply-adds per (query row, key row) pair (1088 at full width), on the
// tensor cores against the bytes (the queries and the output, f32 [T*H, r],
// read and written once): at path 4's chunk (T = 128 after a 128-token
// prefix) about 71 MB against 6.8 GFLOP — bytes, at the bf16 rate.
//
// Design: the tensor-core tile of mla_tile.cuh.  One block per (64 flattened
// query rows, slot) — at full width half of one token's heads — launched
// last row tile first (the causal suffix makes the late tiles the longest).
// The block streams the slot's live prefix rows in 32-key tiles gathered
// through the table (rows at or past prefix_len zero-filled, never read;
// int8 codes with their row scales), then the chunk's raw latents in
// 32-key tiles up to the last row its causal mask admits; a warp skips a
// suffix tile above its rows' diagonal, and key n-tiles past a tile's live
// keys skip their MMAs.  Instances: (f32 suffix, f32 pools) is 3xTF32 in
// both phases, (bf16, bf16) bf16x3 in both, and with int8 pools the prefix
// phase is bf16x3 on the codes while the suffix phase follows the suffix's
// type; the ring stage is sized for the wider of the two key types.
//
// The CUDA-core path (widths whose tile stage does not fit in shared
// memory, mla_tc::make_geo): one block of 256 threads per (16 flattened
// rows, slot) stages each prefix page and chunk tile as f32 and scores it
// from shared memory (mla:: helpers in common.cuh).

#include <type_traits>

#include "common.cuh"
#include "mla_tile.cuh"

namespace {

// ------------------------------------------------------- tensor-core path
template <typename ST, typename PT>
__global__ void __launch_bounds__(mla_tc::kThreads, 1)
prefill_tc_kernel(const float* __restrict__ q_lat,
                  const float* __restrict__ q_pe,
                  const ST* __restrict__ ckv_suf,
                  const ST* __restrict__ kpe_suf,
                  const PT* __restrict__ ckv_pool,
                  const PT* __restrict__ kpe_pool,
                  const float* __restrict__ ckv_s,
                  const float* __restrict__ kpe_s,
                  const int* __restrict__ table,
                  const int* __restrict__ prefix_len,
                  const int* __restrict__ chunk_len, float* __restrict__ out,
                  int T, int H, int PS, int P, const mla_tc::Geo G) {
  using namespace mla_tc;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TH = T * H;
  const int R0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y;
  const int nrows = min(kRows, TH - R0);
  const int pfx = min(max(prefix_len[b], 0), P * PS);
  const int cl = min(max(chunk_len[b], 0), T);
  const int kv_end = min((R0 + nrows - 1) / H + 1, cl);
  const int n_pt = (pfx + kKeys - 1) / kKeys;
  const int n_tiles = n_pt + (kv_end + kKeys - 1) / kKeys;
  const size_t qrow0 = (size_t)b * TH + R0;

  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + q_bytes(G);
  float* ex = reinterpret_cast<float*>(smem + G.ex_off);
  stage_queries(qs, G, q_lat + qrow0 * G.r, q_pe + qrow0 * G.dr, nrows);

  const int* tb = table + (size_t)b * P;
  const ST* cb = ckv_suf + (size_t)b * T * G.r;
  const ST* kb = kpe_suf + (size_t)b * T * G.dr;
  auto issue = [&](int i, int st) {
    unsigned char* kd = ring + (size_t)st * G.stage_bytes;
    if (i < n_pt) {
      const int j0 = i * kKeys;
      stage_keys(kd, G, ckv_pool, kpe_pool, kQuant ? ckv_s : nullptr, kpe_s,
                 G.pc, G.pp, [&](int k) -> long long {
                   const int kv = j0 + k;
                   if (kv >= pfx) return -1;
                   return (long long)tb[kv / PS] * PS + kv % PS;
                 });
    } else {
      const int j0 = (i - n_pt) * kKeys;
      stage_keys(kd, G, cb, kb, static_cast<const float*>(nullptr), nullptr,
                 G.psc, G.psp, [&](int k) -> long long {
                   const int j = j0 + k;
                   return j < kv_end ? j : -1;
                 });
    }
  };

  const Warp w = warp_of(G);
  const int ta = (R0 + w.wr + w.g) / H;        // chunk position of row g
  const int tb8 = (R0 + w.wr + w.g + 8) / H;   // and of row g + 8
  const int t_warp = (R0 + w.wr + 15) / H;     // of the warp's last row
  float o[kNT][4], m[2], lp[2];
  init_state(o, m, lp);
  run_ring(G, ring, n_tiles, issue, [&](int i, const unsigned char* kd) {
    if (i < n_pt) {
      const int nlive = min(kKeys, pfx - i * kKeys);
      tile_step<PT, kQuant>(o, m, lp, qs, kd, ex, G, w, nlive,
                            [&](int, int c) { return c < nlive; });
      return;
    }
    const int j0 = (i - n_pt) * kKeys;
    // keys past min(t_warp + 1, cl) are masked for every row of the warp
    const int nlive = min(kKeys, min(t_warp + 1, cl) - j0);
    if (nlive <= 0) return;   // the whole tile is above the warp's diagonal
    tile_step<ST, false>(o, m, lp, qs, kd, ex, G, w, nlive,
                         [&](int e, int c) {
      const int j = j0 + c;
      return j <= (e < 2 ? ta : tb8) && j < cl;
    });
  });

  float l[2];
  row_sums(l, lp, ex, w);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = w.wr + w.g + 8 * rr;
    if (row < nrows)
      put_row(out + (qrow0 + row) * G.r, o, rr, fmaxf(l[rr], 1e-30f), G, w);
  }
}

// --------------------------------------------------------- CUDA-core path
constexpr int kSimtThreads = 256;
constexpr int kSimtRows = 16;  // flattened (t, h) query rows per block

template <typename ST, typename PT>
__global__ void __launch_bounds__(kSimtThreads)
mla_prefill_kernel(const float* __restrict__ q_lat,
                   const float* __restrict__ q_pe,
                   const ST* __restrict__ ckv_suf,
                   const ST* __restrict__ kpe_suf,
                   const PT* __restrict__ ckv_pool,
                   const PT* __restrict__ kpe_pool,
                   const float* __restrict__ ckv_s,
                   const float* __restrict__ kpe_s,
                   const int* __restrict__ table,
                   const int* __restrict__ prefix_len,
                   const int* __restrict__ chunk_len, float* __restrict__ out,
                   int T, int H, int r, int dr, int PS, int P, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float smem_f[];
  const int KT = PS;
  const mla::Tile s = mla::carve(smem_f, kSimtRows, KT, r, dr);
  const int R0 = blockIdx.x * kSimtRows, b = blockIdx.y;
  const int nrows = min(kSimtRows, T * H - R0);
  const size_t row0 = (size_t)b * T * H + R0;
  mla::load_queries<kSimtThreads>(s, q_lat, q_pe, row0, nrows, kSimtRows, r,
                                  dr);
  const int pfx = max(prefix_len[b], 0);
  const int cl = min(max(chunk_len[b], 0), T);
  __syncthreads();

  // phase 1: the cached prefix pages (kv < prefix_len, no causal term)
  const int n_pages = min((pfx + PS - 1) / PS, P);
  for (int pg = 0; pg < n_pages; ++pg) {
    const size_t page = (size_t)table[(size_t)b * P + pg];
    mla::stage_keys<kSimtThreads>(s, ckv_pool + page * PS * r,
                              kpe_pool + page * PS * dr,
                              kQuant ? ckv_s + page * PS : nullptr,
                              kQuant ? kpe_s + page * PS : nullptr, PS, KT,
                              r, dr);
    __syncthreads();
    const int base = pg * PS;
    mla::score<kSimtThreads>(s, kSimtRows, KT, r, dr, scale,
                             [&](int rr, int k) {
      return rr < nrows && base + k < pfx;
    });
    mla::update<kSimtThreads>(s, kSimtRows, KT, r);
  }

  // phase 2: the chunk's own raw latents, causal within the chunk
  const int t_last = (R0 + nrows - 1) / H;
  const int kv_end = min(t_last + 1, cl);
  const ST* cb = ckv_suf + (size_t)b * T * r;
  const ST* kb = kpe_suf + (size_t)b * T * dr;
  for (int j0 = 0; j0 < kv_end; j0 += KT) {
    mla::stage_keys<kSimtThreads>(s, cb + (size_t)j0 * r, kb + (size_t)j0 * dr,
                              static_cast<const float*>(nullptr),
                              static_cast<const float*>(nullptr),
                              min(KT, T - j0), KT, r, dr);
    __syncthreads();
    mla::score<kSimtThreads>(s, kSimtRows, KT, r, dr, scale,
                             [&](int rr, int k) {
      const int j = j0 + k;
      return rr < nrows && j <= (R0 + rr) / H && j < cl;
    });
    mla::update<kSimtThreads>(s, kSimtRows, KT, r);
  }

  mla::store<kSimtThreads>(s, out, row0, nrows, r);
}

// ----------------------------------------------------------------- launch
template <typename ST, typename PT>
cudaError_t launch(const float* q_lat, const float* q_pe, const void* ckv_suf,
                   const void* kpe_suf, const void* ckv_pool,
                   const void* kpe_pool, const float* ckv_s,
                   const float* kpe_s, const int* table,
                   const int* prefix_len, const int* chunk_len, float* out,
                   int B, int T, int H, int r, int dr, int PS, int P,
                   float scale, cudaStream_t stream) {
  const ST* cs = static_cast<const ST*>(ckv_suf);
  const ST* ks = static_cast<const ST*>(kpe_suf);
  const PT* cp = static_cast<const PT*>(ckv_pool);
  const PT* kp = static_cast<const PT*>(kpe_pool);
  constexpr bool quant = std::is_same<PT, int8_t>::value;
  mla_tc::Geo G =
      mla_tc::make_geo(r, dr, sizeof(PT), sizeof(ST), quant, scale);
  if (G.stages > 0) {
    G.pq = mla_tc::piece_for(q_lat, (size_t)r * 4, 4);
    G.pqe = mla_tc::piece_for(q_pe, (size_t)dr * 4, 4);
    G.pc = mla_tc::piece_for(cp, (size_t)r * sizeof(PT), sizeof(PT));
    G.pp = mla_tc::piece_for(kp, (size_t)dr * sizeof(PT), sizeof(PT));
    G.psc = mla_tc::piece_for(cs, (size_t)r * sizeof(ST), sizeof(ST));
    G.psp = mla_tc::piece_for(ks, (size_t)dr * sizeof(ST), sizeof(ST));
    const size_t smem = mla_tc::smem_bytes(G);
    cudaError_t err = reserve_smem(prefill_tc_kernel<ST, PT>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T * H + mla_tc::kRows - 1) / mla_tc::kRows, B);
    prefill_tc_kernel<ST, PT><<<grid, mla_tc::kThreads, smem, stream>>>(
        q_lat, q_pe, cs, ks, cp, kp, ckv_s, kpe_s, table, prefix_len,
        chunk_len, out, T, H, PS, P, G);
    return cudaGetLastError();
  }
  const size_t smem =
      sizeof(float) * mla::smem_floats(kSimtRows, PS, r, dr);
  cudaError_t err = reserve_smem(mla_prefill_kernel<ST, PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T * H + kSimtRows - 1) / kSimtRows, B);
  mla_prefill_kernel<ST, PT><<<grid, kSimtThreads, smem, stream>>>(
      q_lat, q_pe, cs, ks, cp, kp, ckv_s, kpe_s, table, prefix_len,
      chunk_len, out, T, H, r, dr, PS, P, scale);
  return cudaGetLastError();
}

}  // namespace

// 1 where (suffix type, pool type, r, dr) takes the tensor-core tile, 0
// where the CUDA-core path, -1 for an unknown type.
extern "C" int repro_mla_paged_prefill_route(int suf_dtype, int pool_dtype,
                                             int r, int dr) {
  const int es = mla_tc::elem_bytes(suf_dtype);
  const int ep = mla_tc::elem_bytes(pool_dtype);
  if (es == 0 || ep == 0) return -1;
  return mla_tc::make_geo(r, dr, ep, es, pool_dtype == kI8, 1.f).stages > 0;
}

extern "C" int repro_mla_paged_prefill(
    const void* q_lat, const void* q_pe, const void* ckv_suf,
    const void* kpe_suf, int suf_dtype, const void* ckv_pool,
    const void* kpe_pool, const void* ckv_s, const void* kpe_s,
    int pool_dtype, const void* table, const void* prefix_len,
    const void* chunk_len, void* out, int B, int T, int H, int r, int dr,
    int PS, int P, float scale, void* stream) {
  const float* ql = static_cast<const float*>(q_lat);
  const float* qp = static_cast<const float*>(q_pe);
  const float* cs = static_cast<const float*>(ckv_s);
  const float* ps = static_cast<const float*>(kpe_s);
  const int* tb = static_cast<const int*>(table);
  const int* pl = static_cast<const int*>(prefix_len);
  const int* cl = static_cast<const int*>(chunk_len);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = pool_dtype == kI8;
  if (quant && (cs == nullptr || ps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (suf_dtype == kF32 && pool_dtype == kF32)
    return launch<float, float>(ql, qp, ckv_suf, kpe_suf, ckv_pool, kpe_pool,
                                cs, ps, tb, pl, cl, o, B, T, H, r, dr, PS, P,
                                scale, st);
  if (suf_dtype == kBF16 && pool_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        ql, qp, ckv_suf, kpe_suf, ckv_pool, kpe_pool, cs, ps, tb, pl, cl, o,
        B, T, H, r, dr, PS, P, scale, st);
  if (suf_dtype == kF32 && quant)
    return launch<float, int8_t>(ql, qp, ckv_suf, kpe_suf, ckv_pool, kpe_pool,
                                 cs, ps, tb, pl, cl, o, B, T, H, r, dr, PS, P,
                                 scale, st);
  if (suf_dtype == kBF16 && quant)
    return launch<__nv_bfloat16, int8_t>(
        ql, qp, ckv_suf, kpe_suf, ckv_pool, kpe_pool, cs, ps, tb, pl, cl, o,
        B, T, H, r, dr, PS, P, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
