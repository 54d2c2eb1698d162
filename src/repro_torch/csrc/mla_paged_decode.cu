// B8: absorbed Multi-head Latent Attention (MLA) paged decode — one query
// token per slot against the slot's latent pages, through the block table.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:_mla_kernel
// (entry mla_paged_attention, pallas_call at paged_attention.py:300), both
// branches: fp pools and int8 pools (quant=True, kv_quant).
//
//   q_lat    f32 [B, H, r]     absorbed query (q_nope . w_k)
//   q_pe     f32 [B, H, dr]    rope query
//   ckv_pool T   [NP, PS, r]   latent rows, T = f32, bf16 or int8
//   kpe_pool T   [NP, PS, dr]  rope key rows
//   ckv_s    f32 [NP, PS]      int8 pools only (else null): row scales
//   kpe_s    f32 [NP, PS]
//   table    i32 [B, P]        pool page of each logical page
//   lengths  i32 [B]           valid rows, including this step's token
//   part     f32 [B*H, S, 2 + r]  split partials (null when S == 1)
//   out      f32 [B, H, r]     latent output o_lat
//
// As the reference: s = (q_lat . ckv * ckv_s + q_pe . kpe * kpe_s) * scale
// over the rows pos < lengths[b] (scales 1 for fp pools), online softmax,
// o_lat = sum_j p_j * ckv_s_j * ckv_j / sum_j p_j.  A slot with no valid row
// gives zeros, not NaN.
//
// What bounds it on an H100: every latent row costs H * (r + dr + r)
// multiply-adds (at full width 128 * 1088) against (r + dr) elements read,
// and the query and output rows are read and written once: at path 4's
// decode (B = 4, 489 live rows) about 3.4 MB of f32 and 0.14 GFLOP, so on
// the tensor cores bytes bound it (about 1 us) — the kernel is bound by
// latency: few rows per slot, two launches.
//
// Design: the tensor-core tile of mla_tile.cuh (64 heads of one slot per
// block, 32-key latent tiles whose keys the two warps of a row group split
// for the scores, two warpgroups on the two halves of the value columns,
// exact 3xTF32 or bf16x3 operand splits), split-KV as K2
// (gqa_paged_decode.cu): the grid is (H / 64, B, S), each slot's P table
// pages cut into S <= 32 splits of pps pages (S and pps from static shapes
// only — B, H, P, PS and the SM count, kernels/paged_attention.py
// mla_decode_splits: one block per SM, at least one 32-key tile per split
// — never from `lengths`, so a launch needs no host sync and can be
// captured in a CUDA graph; at path 4's decode, 4 slots of 16 pages of
// 16 rows, 8 splits of 2 pages, which ran faster than 16 of one page:
// PERF.md).  A block walks the live rows of its split
// only, rows < min(lengths[b], P * PS): dead table entries, which point at
// the trash page 0, are never read; a split whose rows all lie past the
// length writes the reference's empty state (m = -1e30, l = 0, acc = 0).
// Each split leaves its unnormalised state (m, l, acc[r]) per head in
// `part`; a second kernel of the same call reduces the S states in split
// order s = 0..S-1 (m = max m_s, l = sum l_s e^(m_s - m), acc likewise,
// out = acc / max(l, 1e-30)): no atomics, bitwise repeatable.  With S == 1
// the block writes `out` itself.
//
// The CUDA-core path (widths whose tile stage does not fit in shared
// memory, mla_tc::make_geo): one block of 128 threads per (8 heads, slot)
// walks all of the slot's live pages, staging each as f32 and scoring it
// from shared memory (mla:: helpers in common.cuh); it writes `out`
// directly and takes no splits.

#include <type_traits>

#include "common.cuh"
#include "mla_tile.cuh"

namespace {

// ------------------------------------------------------- tensor-core path
// Block (64 heads, slot b, split s): the split's state of each head, to
// `out` normalised (S == 1) or to the head's partial slot.
template <typename PT>
__global__ void __launch_bounds__(mla_tc::kThreads, 1)
decode_tc_kernel(const float* __restrict__ q_lat,
                 const float* __restrict__ q_pe,
                 const PT* __restrict__ ckv_pool,
                 const PT* __restrict__ kpe_pool,
                 const float* __restrict__ ckv_s,
                 const float* __restrict__ kpe_s,
                 const int* __restrict__ table,
                 const int* __restrict__ lengths, float* __restrict__ part,
                 float* __restrict__ out, int H, int PS, int P, int pps,
                 const mla_tc::Geo G) {
  using namespace mla_tc;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h0 = blockIdx.x * kRows, b = blockIdx.y;
  const int s = blockIdx.z, S = gridDim.z;
  const int nrows = min(kRows, H - h0);
  const int len = min(max(lengths[b], 0), P * PS);
  const int row0 = s * pps * PS;
  const int row1 = min(row0 + pps * PS, len);
  const size_t qrow0 = (size_t)b * H + h0;
  const int r = G.r;

  if (row0 >= row1) {   // nothing live in this split: the empty state
    for (int i = threadIdx.x; i < nrows * r; i += kThreads) {
      const size_t row = qrow0 + i / r;
      const int c = i % r;
      if (S == 1) {
        out[row * r + c] = 0.f;
        continue;
      }
      float* p = part + (row * S + s) * (size_t)(2 + r);
      if (c == 0) {
        p[0] = REPRO_NEG_INF;
        p[1] = 0.f;
      }
      p[2 + c] = 0.f;
    }
    return;
  }

  float* qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + q_bytes(G);
  float* ex = reinterpret_cast<float*>(smem + G.ex_off);
  stage_queries(qs, G, q_lat + qrow0 * r, q_pe + qrow0 * G.dr, nrows);

  const int* tb = table + (size_t)b * P;
  const int n_tiles = (row1 - row0 + kKeys - 1) / kKeys;
  auto issue = [&](int i, int st) {
    const int j0 = row0 + i * kKeys;
    stage_keys(ring + (size_t)st * G.stage_bytes, G, ckv_pool, kpe_pool,
               kQuant ? ckv_s : nullptr, kpe_s, G.pc, G.pp,
               [&](int k) -> long long {
                 const int kv = j0 + k;
                 if (kv >= row1) return -1;
                 return (long long)tb[kv / PS] * PS + kv % PS;
               });
  };

  const Warp w = warp_of(G);
  float o[kNT][4], m[2], lp[2];
  init_state(o, m, lp);
  run_ring(G, ring, n_tiles, issue, [&](int i, const unsigned char* kd) {
    const int nlive = min(kKeys, row1 - row0 - i * kKeys);
    tile_step<PT, kQuant>(o, m, lp, qs, kd, ex, G, w, nlive,
                          [&](int, int c) { return c < nlive; });
  });

  float l[2];
  row_sums(l, lp, ex, w);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = w.wr + w.g + 8 * rr;
    if (row >= nrows) continue;
    const size_t qrow = qrow0 + row;
    if (S == 1) {
      put_row(out + qrow * r, o, rr, fmaxf(l[rr], 1e-30f), G, w);
      continue;
    }
    float* p = part + (qrow * S + s) * (size_t)(2 + r);
    if (w.vh == 0 && w.tq == 0) {
      p[0] = m[rr];
      p[1] = l[rr];
    }
    put_row(p + 2, o, rr, 1.f, G, w);
  }
}

// out[row] = the split-order reduction of the S (<= kMaxSplits) partial
// states of `row`; the splits' weights e^(m_s - m) are computed once.
constexpr int kMaxSplits = 32;

__global__ void __launch_bounds__(128)
combine_kernel(const float* __restrict__ part, float* __restrict__ out,
               int S, int r) {
  __shared__ float w[kMaxSplits];
  __shared__ float inv;
  const size_t row = blockIdx.x;
  const float* p = part + row * S * (size_t)(2 + r);
  if (threadIdx.x == 0) {
    float M = REPRO_NEG_INF;
    for (int s = 0; s < S; ++s) M = fmaxf(M, p[(size_t)s * (2 + r)]);
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ps = p + (size_t)s * (2 + r);
      w[s] = expf(ps[0] - M);
      l += ps[1] * w[s];
    }
    inv = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += p[(size_t)s * (2 + r) + 2 + d] * w[s];
    out[row * r + d] = a * inv;
  }
}

// --------------------------------------------------------- CUDA-core path
constexpr int kSimtThreads = 128;
constexpr int kHeads = 8;  // query heads per block

template <typename PT>
__global__ void __launch_bounds__(kSimtThreads)
mla_decode_kernel(const float* __restrict__ q_lat,
                  const float* __restrict__ q_pe,
                  const PT* __restrict__ ckv_pool,
                  const PT* __restrict__ kpe_pool,
                  const float* __restrict__ ckv_s,
                  const float* __restrict__ kpe_s,
                  const int* __restrict__ table,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  int H, int r, int dr, int PS, int P, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float smem_f[];
  const mla::Tile s = mla::carve(smem_f, kHeads, PS, r, dr);
  const int h0 = blockIdx.x * kHeads, b = blockIdx.y;
  const int nh = min(kHeads, H - h0);
  const size_t row0 = (size_t)b * H + h0;
  mla::load_queries<kSimtThreads>(s, q_lat, q_pe, row0, nh, kHeads, r, dr);
  const int len = max(lengths[b], 0);
  const int live = min((len + PS - 1) / PS, P);
  __syncthreads();

  for (int p = 0; p < live; ++p) {
    const size_t page = (size_t)table[(size_t)b * P + p];
    mla::stage_keys<kSimtThreads>(s, ckv_pool + page * PS * r,
                                  kpe_pool + page * PS * dr,
                                  kQuant ? ckv_s + page * PS : nullptr,
                                  kQuant ? kpe_s + page * PS : nullptr, PS,
                                  PS, r, dr);
    __syncthreads();
    const int base = p * PS;
    mla::score<kSimtThreads>(s, kHeads, PS, r, dr, scale,
                             [&](int rr, int k) {
                               return rr < nh && base + k < len;
                             });
    mla::update<kSimtThreads>(s, kHeads, PS, r);
  }
  mla::store<kSimtThreads>(s, out, row0, nh, r);
}

// ----------------------------------------------------------------- launch
template <typename PT>
cudaError_t launch(const float* q_lat, const float* q_pe, const void* ckv_v,
                   const void* kpe_v, const float* ckv_s, const float* kpe_s,
                   const int* table, const int* lengths, float* part,
                   float* out, int B, int H, int r, int dr, int PS, int P,
                   int S, int pps, float scale, cudaStream_t stream) {
  const PT* ckv = static_cast<const PT*>(ckv_v);
  const PT* kpe = static_cast<const PT*>(kpe_v);
  constexpr bool quant = std::is_same<PT, int8_t>::value;
  mla_tc::Geo G =
      mla_tc::make_geo(r, dr, sizeof(PT), sizeof(PT), quant, scale);
  if (G.stages > 0) {
    G.pq = mla_tc::piece_for(q_lat, (size_t)r * 4, 4);
    G.pqe = mla_tc::piece_for(q_pe, (size_t)dr * 4, 4);
    G.pc = mla_tc::piece_for(ckv, (size_t)r * sizeof(PT), sizeof(PT));
    G.pp = mla_tc::piece_for(kpe, (size_t)dr * sizeof(PT), sizeof(PT));
    const size_t smem = mla_tc::smem_bytes(G);
    cudaError_t err = reserve_smem(decode_tc_kernel<PT>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((H + mla_tc::kRows - 1) / mla_tc::kRows, B, S);
    decode_tc_kernel<PT><<<grid, mla_tc::kThreads, smem, stream>>>(
        q_lat, q_pe, ckv, kpe, ckv_s, kpe_s, table, lengths, part, out, H,
        PS, P, pps, G);
    err = cudaGetLastError();
    if (err != cudaSuccess || S == 1) return err;
    combine_kernel<<<B * H, 128, 0, stream>>>(part, out, S, r);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * mla::smem_floats(kHeads, PS, r, dr);
  cudaError_t err = reserve_smem(mla_decode_kernel<PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((H + kHeads - 1) / kHeads, B);
  mla_decode_kernel<PT><<<grid, kSimtThreads, smem, stream>>>(
      q_lat, q_pe, ckv, kpe, ckv_s, kpe_s, table, lengths, out, H, r, dr, PS,
      P, scale);
  return cudaGetLastError();
}

}  // namespace

// 1 where (pool type, r, dr) takes the tensor-core tile, 0 where the
// CUDA-core path, -1 for an unknown type.
extern "C" int repro_mla_paged_decode_route(int pool_dtype, int r, int dr) {
  const int es = mla_tc::elem_bytes(pool_dtype);
  if (es == 0) return -1;
  return mla_tc::make_geo(r, dr, es, es, pool_dtype == kI8, 1.f).stages > 0;
}

extern "C" int repro_mla_paged_decode(const void* q_lat, const void* q_pe,
                                      const void* ckv_pool,
                                      const void* kpe_pool,
                                      const void* ckv_s, const void* kpe_s,
                                      int pool_dtype, const void* table,
                                      const void* lengths, void* part,
                                      void* out, int B, int H, int r, int dr,
                                      int PS, int P, int S, int pps,
                                      float scale, void* stream) {
  const float* ql = static_cast<const float*>(q_lat);
  const float* qp = static_cast<const float*>(q_pe);
  const float* cs = static_cast<const float*>(ckv_s);
  const float* ps = static_cast<const float*>(kpe_s);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > kMaxSplits || pps < 1 || (S > 1 && pt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_dtype == kF32)
    return launch<float>(ql, qp, ckv_pool, kpe_pool, cs, ps, tb, ln, pt, o, B,
                         H, r, dr, PS, P, S, pps, scale, st);
  if (pool_dtype == kBF16)
    return launch<__nv_bfloat16>(ql, qp, ckv_pool, kpe_pool, cs, ps, tb, ln,
                                 pt, o, B, H, r, dr, PS, P, S, pps, scale,
                                 st);
  if (pool_dtype == kI8) {
    if (cs == nullptr || ps == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<int8_t>(ql, qp, ckv_pool, kpe_pool, cs, ps, tb, ln, pt, o,
                          B, H, r, dr, PS, P, S, pps, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
