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
// What bounds it on an H100: the score and value FLOPs, (r + dr + r) * 2 per
// (query row, key row) pair (2176 at full width), on the CUDA cores (f32,
// 67 TFLOP/s) — this first kernel does not use the tensor cores.
//
// Design: one block of 256 threads per (tile of kRows = 16 flattened query
// rows, slot); at full width a tile is 16 heads of one token.  The block
// streams the slot's live prefix pages (ceil(prefix_len / PS), dead table
// entries never read; int8 codes staged with 4-byte vector loads and the
// page's row scales beside them), then the chunk's raw latents in tiles of
// PS rows up to the last row its causal mask admits.  Each tile is staged
// in shared memory once and scored by all kRows rows; the [kRows, r]
// accumulator and the softmax state live in shared memory (mla:: helpers in
// common.cuh).  r and dr are runtime loop bounds, not template instances.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // flattened (t, h) query rows per block

template <typename ST, typename PT>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  const int KT = PS;
  const mla::Tile s = mla::carve(smem, kRows, KT, r, dr);
  const int R0 = blockIdx.x * kRows, b = blockIdx.y;
  const int nrows = min(kRows, T * H - R0);
  const size_t row0 = (size_t)b * T * H + R0;
  mla::load_queries<kThreads>(s, q_lat, q_pe, row0, nrows, kRows, r, dr);
  const int pfx = max(prefix_len[b], 0);
  const int cl = min(max(chunk_len[b], 0), T);
  __syncthreads();

  // phase 1: the cached prefix pages (kv < prefix_len, no causal term)
  const int n_pages = min((pfx + PS - 1) / PS, P);
  for (int pg = 0; pg < n_pages; ++pg) {
    const size_t page = (size_t)table[(size_t)b * P + pg];
    mla::stage_keys<kThreads>(s, ckv_pool + page * PS * r,
                              kpe_pool + page * PS * dr,
                              kQuant ? ckv_s + page * PS : nullptr,
                              kQuant ? kpe_s + page * PS : nullptr, PS, KT,
                              r, dr);
    __syncthreads();
    const int base = pg * PS;
    mla::score<kThreads>(s, kRows, KT, r, dr, scale, [&](int rr, int k) {
      return rr < nrows && base + k < pfx;
    });
    mla::update<kThreads>(s, kRows, KT, r);
  }

  // phase 2: the chunk's own raw latents, causal within the chunk
  const int t_last = (R0 + nrows - 1) / H;
  const int kv_end = min(t_last + 1, cl);
  const ST* cb = ckv_suf + (size_t)b * T * r;
  const ST* kb = kpe_suf + (size_t)b * T * dr;
  for (int j0 = 0; j0 < kv_end; j0 += KT) {
    mla::stage_keys<kThreads>(s, cb + (size_t)j0 * r, kb + (size_t)j0 * dr,
                              static_cast<const float*>(nullptr),
                              static_cast<const float*>(nullptr),
                              min(KT, T - j0), KT, r, dr);
    __syncthreads();
    mla::score<kThreads>(s, kRows, KT, r, dr, scale, [&](int rr, int k) {
      const int j = j0 + k;
      return rr < nrows && j <= (R0 + rr) / H && j < cl;
    });
    mla::update<kThreads>(s, kRows, KT, r);
  }

  mla::store<kThreads>(s, out, row0, nrows, r);
}

template <typename ST, typename PT>
cudaError_t launch(const float* q_lat, const float* q_pe, const void* ckv_suf,
                   const void* kpe_suf, const void* ckv_pool,
                   const void* kpe_pool, const float* ckv_s,
                   const float* kpe_s, const int* table,
                   const int* prefix_len, const int* chunk_len, float* out,
                   int B, int T, int H, int r, int dr, int PS, int P,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * mla::smem_floats(kRows, PS, r, dr);
  cudaError_t err = reserve_smem(mla_prefill_kernel<ST, PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T * H + kRows - 1) / kRows, B);
  mla_prefill_kernel<ST, PT><<<grid, kThreads, smem, stream>>>(
      q_lat, q_pe, static_cast<const ST*>(ckv_suf),
      static_cast<const ST*>(kpe_suf), static_cast<const PT*>(ckv_pool),
      static_cast<const PT*>(kpe_pool), ckv_s, kpe_s, table, prefix_len,
      chunk_len, out, T, H, r, dr, PS, P, scale);
  return cudaGetLastError();
}

}  // namespace

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
