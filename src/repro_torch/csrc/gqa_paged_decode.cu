// K2: paged GQA decode attention — one query token per slot against the
// paged K/V pools, through the block table.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py:_gqa_kernel
// (entry gqa_paged_attention, pallas_call at paged_attention.py:174), both
// branches: fp pools and int8 pools (quant=True, kv_quant).
//
//   q       f32 [B, Hkv, grp, Dh]       (the slot's grp query heads per KV head)
//   k_pool  T   [NP, PS, Hkv, Dh]       T = f32, bf16 or int8
//   v_pool  T   [NP, PS, Hkv, Dv]
//   k_scale f32 [NP, PS, Hkv]           int8 pools only (else null): per
//   v_scale f32 [NP, PS, Hkv]           (position, head) dequant scales
//   table   i32 [B, P]                  pool page of each logical page
//   lengths i32 [B]                     valid rows, including this step's token
//   out     f32 [B, Hkv, grp, Dv]
//
// Int8 pools, as the reference (paged_attention.py:92-105): the score is
// (q . k_codes) * sm_scale * k_scale[row]; the softmax sum l takes the
// unscaled exp; only the probabilities that multiply the V codes are scaled
// by v_scale[row].
//
// What bounds it on an H100: the live K/V rows it streams,
// sum_b lengths[b] * Hkv * (Dh + Dv) elements (plus two f32 scales per row
// and head for int8 pools) — HBM bytes (3.35 TB/s); the FLOPs per byte are
// ~grp/2, far below the card's ridge point.
//
// Design: one block per (kv head, slot).  It loops over the slot's live
// pages only, ceil(lengths[b] / PS) of them, so dead table entries (which
// point at the trash page 0) are never read.  Each page's [PS, Dh] K rows and
// [PS, Dv] V rows (row stride Hkv*Dh in the pool) are staged in shared
// memory as f32 (int8 codes with 4-byte vector loads), with the page's K/V
// scales beside them for int8 pools; the grp query rows score them, and the
// online softmax state (m, l, acc) lives in shared memory.  Rows past
// lengths[b] are masked with the reference's -1e30 and contribute
// exp(.) = 0; the final division is by max(l, 1e-30), so an empty slot gives
// zeros, not NaN.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

size_t smem_floats(int grp, int Dh, int Dv, int PS) {
  return (size_t)grp * Dh            // q
         + (size_t)PS * (Dh + 1)     // K page (padded rows: no bank conflicts)
         + (size_t)PS * (Dv + 1)     // V page
         + 2 * (size_t)PS            // K, V row scales (int8 pools)
         + (size_t)grp * PS          // scores / probabilities
         + (size_t)grp * Dv          // acc
         + 3 * (size_t)grp;          // m, l, correction
}

template <typename PT>
__global__ void __launch_bounds__(kThreads)
gqa_decode_kernel(const float* __restrict__ q, const PT* __restrict__ k_pool,
                  const PT* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ table,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  int Hkv, int grp, int Dh, int Dv, int PS, int P,
                  float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ldk = Dh + 1, ldv = Dv + 1;
  float* q_s = smem;
  float* k_s = q_s + grp * Dh;
  float* v_s = k_s + PS * ldk;
  float* ks_s = v_s + PS * ldv;
  float* vs_s = ks_s + PS;
  float* p_s = vs_s + PS;
  float* acc = p_s + grp * PS;
  float* m_s = acc + grp * Dv;
  float* l_s = m_s + grp;
  float* c_s = l_s + grp;

  const float* qb = q + ((size_t)b * Hkv + h) * grp * Dh;
  for (int i = tid; i < grp * Dh; i += kThreads) q_s[i] = qb[i];
  for (int i = tid; i < grp * Dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < grp; i += kThreads) {
    m_s[i] = REPRO_NEG_INF;
    l_s[i] = 0.f;
  }
  const int len = max(lengths[b], 0);
  const int live = min((len + PS - 1) / PS, P);
  const size_t k_row = (size_t)Hkv * Dh, v_row = (size_t)Hkv * Dv;
  __syncthreads();

  for (int p = 0; p < live; ++p) {
    const size_t page = (size_t)table[(size_t)b * P + p];
    stage_tile<kThreads>(k_s, ldk,
                         k_pool + page * PS * k_row + (size_t)h * Dh, k_row,
                         PS, Dh);
    stage_tile<kThreads>(v_s, ldv,
                         v_pool + page * PS * v_row + (size_t)h * Dv, v_row,
                         PS, Dv);
    if (kQuant) {
      for (int r = tid; r < PS; r += kThreads) {
        ks_s[r] = k_scale[(page * PS + r) * Hkv + h];
        vs_s[r] = v_scale[(page * PS + r) * Hkv + h];
      }
    }
    __syncthreads();
    for (int i = tid; i < grp * PS; i += kThreads) {
      const int g = i / PS, r = i - g * PS;
      float s = REPRO_NEG_INF;
      if (p * PS + r < len) {
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d)
          dot = fmaf(q_s[g * Dh + d], k_s[r * ldk + d], dot);
        s = dot * scale;
        if (kQuant) s *= ks_s[r];
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = tid; g < grp; g += kThreads) {
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int r = 0; r < PS; ++r) m_new = fmaxf(m_new, p_s[g * PS + r]);
      float sum = 0.f;
      for (int r = 0; r < PS; ++r) {
        const bool valid = p * PS + r < len;
        const float e = valid ? expf(p_s[g * PS + r] - m_new) : 0.f;
        sum += e;
        // l takes the unscaled exp; the value weights carry v_scale
        p_s[g * PS + r] = kQuant ? (valid ? e * vs_s[r] : 0.f) : e;
      }
      const float corr = expf(m_prev - m_new);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      c_s[g] = corr;
    }
    __syncthreads();
    for (int i = tid; i < grp * Dv; i += kThreads) {
      const int g = i / Dv, d = i - g * Dv;
      float a = acc[i] * c_s[g];
      for (int r = 0; r < PS; ++r) a = fmaf(p_s[g * PS + r], v_s[r * ldv + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)b * Hkv + h) * grp * Dv;
  for (int i = tid; i < grp * Dv; i += kThreads)
    ob[i] = acc[i] / fmaxf(l_s[i / Dv], 1e-30f);
}

template <typename PT>
cudaError_t launch(const float* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* lengths, float* out, int B,
                   int Hkv, int grp, int Dh, int Dv, int PS, int P, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(grp, Dh, Dv, PS);
  cudaError_t err = reserve_smem(gqa_decode_kernel<PT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  gqa_decode_kernel<PT><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const PT*>(k_pool), static_cast<const PT*>(v_pool),
      k_scale, v_scale, table, lengths, out, Hkv, grp, Dh, Dv, PS, P, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gqa_paged_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, int pool_dtype,
                                      const void* table, const void* lengths,
                                      void* out, int B, int Hkv, int grp,
                                      int Dh, int Dv, int PS, int P,
                                      float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_dtype == kF32)
    return launch<float>(qf, k_pool, v_pool, ks, vs, tb, ln, o, B, Hkv, grp,
                         Dh, Dv, PS, P, scale, s);
  if (pool_dtype == kBF16)
    return launch<__nv_bfloat16>(qf, k_pool, v_pool, ks, vs, tb, ln, o, B,
                                 Hkv, grp, Dh, Dv, PS, P, scale, s);
  if (pool_dtype == kI8) {
    if (ks == nullptr || vs == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<int8_t>(qf, k_pool, v_pool, ks, vs, tb, ln, o, B, Hkv, grp,
                          Dh, Dv, PS, P, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
