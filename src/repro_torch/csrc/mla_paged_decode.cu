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
//   out      f32 [B, H, r]     latent output o_lat
//
// As the reference: s = (q_lat . ckv * ckv_s + q_pe . kpe * kpe_s) * scale
// over the rows pos < lengths[b] (scales 1 for fp pools), online softmax,
// o_lat = sum_j p_j * ckv_s_j * ckv_j / sum_j p_j.  A slot with no valid row
// gives zeros, not NaN.
//
// What bounds it on an H100: MLA is MQA with H query heads on one latent
// "KV head", so every latent row costs H * (r + dr + r) * 2 FLOP (at full
// width 128 * 1088 * 2) against (r + dr) * 4 bytes: ~ 580 FLOP per byte in
// f32, above the card's f32 ridge point (67 TFLOP/s / 3.35 TB/s = 20): the
// operations on the CUDA cores (f32, no tensor cores in this first kernel).
//
// Design: one block of 128 threads per (tile of kHeads = 8 heads, slot).
// It walks the slot's live pages only, ceil(lengths[b] / PS) of them, so
// dead table entries (which point at the trash page 0) are never read.  Each
// page's [PS, r] latent rows and [PS, dr] rope rows are staged in shared
// memory as f32 (int8 codes with 4-byte vector loads, the row scales beside
// them) and scored by all kHeads heads of the tile: a page is read once per
// tile of heads, not once per head.  The [kHeads, r] accumulator and the
// softmax state live in shared memory (mla:: helpers in common.cuh).  r and
// dr are runtime loop bounds, not template instances.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeads = 8;  // query heads per block

template <typename PT>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  const mla::Tile s = mla::carve(smem, kHeads, PS, r, dr);
  const int h0 = blockIdx.x * kHeads, b = blockIdx.y;
  const int nh = min(kHeads, H - h0);
  const size_t row0 = (size_t)b * H + h0;
  mla::load_queries<kThreads>(s, q_lat, q_pe, row0, nh, kHeads, r, dr);
  const int len = max(lengths[b], 0);
  const int live = min((len + PS - 1) / PS, P);
  __syncthreads();

  for (int p = 0; p < live; ++p) {
    const size_t page = (size_t)table[(size_t)b * P + p];
    mla::stage_keys<kThreads>(s, ckv_pool + page * PS * r,
                              kpe_pool + page * PS * dr,
                              kQuant ? ckv_s + page * PS : nullptr,
                              kQuant ? kpe_s + page * PS : nullptr, PS, PS,
                              r, dr);
    __syncthreads();
    const int base = p * PS;
    mla::score<kThreads>(s, kHeads, PS, r, dr, scale, [&](int rr, int k) {
      return rr < nh && base + k < len;
    });
    mla::update<kThreads>(s, kHeads, PS, r);
  }
  mla::store<kThreads>(s, out, row0, nh, r);
}

template <typename PT>
cudaError_t launch(const float* q_lat, const float* q_pe, const void* ckv,
                   const void* kpe, const float* ckv_s, const float* kpe_s,
                   const int* table, const int* lengths, float* out, int B,
                   int H, int r, int dr, int PS, int P, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * mla::smem_floats(kHeads, PS, r, dr);
  cudaError_t err = reserve_smem(mla_decode_kernel<PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((H + kHeads - 1) / kHeads, B);
  mla_decode_kernel<PT><<<grid, kThreads, smem, stream>>>(
      q_lat, q_pe, static_cast<const PT*>(ckv), static_cast<const PT*>(kpe),
      ckv_s, kpe_s, table, lengths, out, H, r, dr, PS, P, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_mla_paged_decode(const void* q_lat, const void* q_pe,
                                      const void* ckv_pool,
                                      const void* kpe_pool,
                                      const void* ckv_s, const void* kpe_s,
                                      int pool_dtype, const void* table,
                                      const void* lengths, void* out, int B,
                                      int H, int r, int dr, int PS, int P,
                                      float scale, void* stream) {
  const float* ql = static_cast<const float*>(q_lat);
  const float* qp = static_cast<const float*>(q_pe);
  const float* cs = static_cast<const float*>(ckv_s);
  const float* ps = static_cast<const float*>(kpe_s);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == kF32)
    return launch<float>(ql, qp, ckv_pool, kpe_pool, cs, ps, tb, ln, o, B, H,
                         r, dr, PS, P, scale, st);
  if (pool_dtype == kBF16)
    return launch<__nv_bfloat16>(ql, qp, ckv_pool, kpe_pool, cs, ps, tb, ln,
                                 o, B, H, r, dr, PS, P, scale, st);
  if (pool_dtype == kI8) {
    if (cs == nullptr || ps == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<int8_t>(ql, qp, ckv_pool, kpe_pool, cs, ps, tb, ln, o, B, H,
                          r, dr, PS, P, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
