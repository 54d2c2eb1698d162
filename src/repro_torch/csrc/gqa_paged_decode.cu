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
//   part    f32 [B*Hkv*grp, S, 2 + Dv]  split partials (null when S == 1)
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
// ~grp/2, far below the card's ridge point.  So the design is about bytes in
// flight: enough blocks on every SM, and several independent wide loads per
// thread outstanding at once.
//
// Split-KV.  The grid is (Hkv * head chunks, B, S): each slot's P table
// pages are cut into S splits of `pps` pages (S and pps come from static
// shapes only — B, Hkv, grp, P and the SM count, kernels/paged_attention.py
// gqa_decode_splits — never from `lengths`, so a launch needs no host sync
// and can be captured in a CUDA graph).  A block walks the live rows of its
// split only (rows < min(lengths[b], P * PS)): dead table entries, which
// point at the trash page 0, are never read, and a split whose pages all
// lie past lengths[b] writes the empty state (m = -1e30, l = 0, acc = 0)
// and exits.  Each split leaves its unnormalised online-softmax state
// (m, l, acc[Dv]) per query head in `part`; a second kernel, launched by
// the same call, reduces the S states in split order s = 0..S-1:
//   m = max_s m_s;  l = sum_s l_s e^(m_s - m);  acc = sum_s acc_s e^(m_s - m)
//   out = acc / max(l, 1e-30)
// (no atomics: bitwise repeatable).  With S == 1 the block writes out itself.
// The empty state uses the reference's -1e30, not -inf: e^(m_s - m) stays 1
// (never NaN) when every split is empty, and an empty slot gives zeros.
//
// Inside a block (the register path): 4 warps; a warp takes key rows, not
// threads.  A row is read by a group of L lanes (L = 32 for Dh = 128, 16
// for Dh = 64), each lane holding kNC slices of 4 elements of it, read as
// one 16-byte (f32), 8-byte (bf16) or 4-byte (int8 codes) load per slice.
// The block's grp query rows (at most kG = 8 of them; larger groups take
// several head chunks, each re-reading the K/V) sit in registers, so one K
// row is scored for all of them: a lane's partial dot products are summed
// by xor shuffles within its group.  Each lane group keeps kUnroll rows'
// loads in flight before it scores any of them (with enough blocks per SM
// this keeps the HBM pipe full without cp.async; PERF.md records the
// measurement), and one online-softmax step per kUnroll rows keeps
// (m, l, acc) in registers.  At the end the block's lane groups merge their
// states through shared memory in a fixed order.
//
// The general path takes every other shape the reference takes (Dh or Dv
// not a multiple of 4 or wider than 256, pools not aligned for the vector
// loads): the same split grid and partials, with each split's pages staged
// in shared memory as f32 by all threads, the grp rows scoring from shared
// memory.

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;       // query heads a block holds in registers

// One launch's operands (device pointers; the pools of the launch's type)
// and shapes.
struct Args {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lengths;
  float* part;
  float* out;
  int B, Hkv, grp, Dh, Dv, PS, P, S, pps;
  float scale;
};

// Four pool elements (one slice of a row) as f32, by one vector load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 c = __ldg(reinterpret_cast<const char4*>(p));
  v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
}

// The split's state for one query row: to `out` (S == 1: normalised) or to
// its partial slot.
__device__ __forceinline__ void put_state(float* __restrict__ part,
                                          float* __restrict__ out,
                                          size_t row, int s, int S, int Dv,
                                          int d, float m, float l, float a) {
  if (S == 1) {
    out[row * Dv + d] = a / fmaxf(l, 1e-30f);
    return;
  }
  float* p = part + (row * S + s) * (size_t)(2 + Dv);
  if (d == 0) {
    p[0] = m;
    p[1] = l;
  }
  p[2 + d] = a;
}

// The register path.  L lanes per row, kNC 4-element slices per lane.
template <typename PT, int kG, int kNC>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Args a, int L) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const float* __restrict__ q = a.q;
  const PT* __restrict__ k_pool = static_cast<const PT*>(a.k_pool);
  const PT* __restrict__ v_pool = static_cast<const PT*>(a.v_pool);
  const float* __restrict__ k_scale = a.k_scale;
  const float* __restrict__ v_scale = a.v_scale;
  float* __restrict__ part = a.part;
  float* __restrict__ out = a.out;
  const int Hkv = a.Hkv, grp = a.grp, Dh = a.Dh, Dv = a.Dv, PS = a.PS;
  const int P = a.P, pps = a.pps;
  const float scale = a.scale;
  // rows per lane group in flight (fewer for two slices: registers)
  constexpr int kUnroll = kNC == 1 ? 4 : 2;
  extern __shared__ float smem[];
  const int hchunks = (grp + kG - 1) / kG;
  const int h = blockIdx.x / hchunks;
  const int g0 = (blockIdx.x - h * hchunks) * kG;
  const int ng = min(kG, grp - g0);
  const int b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int len = min(max(a.lengths[b], 0), P * PS);
  const int row0 = s * pps * PS;
  const int row1 = min(row0 + pps * PS, len);
  const size_t qrow0 = ((size_t)b * Hkv + h) * grp + g0;

  if (row0 >= row1) {   // nothing live in this split: the empty state
    for (int i = threadIdx.x; i < ng * Dv; i += kThreads)
      put_state(part, out, qrow0 + i / Dv, s, S, Dv, i % Dv, REPRO_NEG_INF,
                0.f, 0.f);
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int R = 32 / L;                   // rows a warp reads at once
  const int li = lane % L, gid = warp * R + lane / L;
  const int step = kWarps * R;            // rows per pass of the block

  float qr[kG][kNC][4];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 4 * (li + c * L);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qr[g][c][e] = g < ng && col < Dh
                          ? q[(qrow0 + g) * Dh + col + e]
                          : 0.f;
    }
  float m[kG], l[kG], acc[kG][kNC][4];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][c][e] = 0.f;
  }

  const size_t k_row = (size_t)Hkv * Dh, v_row = (size_t)Hkv * Dv;
  const int* tb = a.table + (size_t)b * P;
  // warp-uniform trip count: the shuffles need every lane of the warp
  for (int wb = row0 + warp * R; wb < row1; wb += step * kUnroll) {
    float kv[kUnroll][kNC][4], vv[kUnroll][kNC][4], ksc[kUnroll],
        vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = wb + lane / L + u * step;
      ok[u] = r < row1;
      ksc[u] = vsc[u] = 0.f;
      size_t pos = 0;
      if (ok[u]) {
        pos = (size_t)__ldg(tb + r / PS) * PS + r % PS;
        if (kQuant) {
          ksc[u] = __ldg(k_scale + pos * Hkv + h);
          vsc[u] = __ldg(v_scale + pos * Hkv + h);
        }
      }
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = 4 * (li + c * L);
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[u][c][e] = vv[u][c][e] = 0.f;
        if (ok[u] && col < Dh) load4(k_pool + pos * k_row + h * Dh + col, kv[u][c]);
        if (ok[u] && col < Dv) load4(v_pool + pos * v_row + h * Dv + col, vv[u][c]);
      }
    }
    float sc[kUnroll][kG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) d = fmaf(qr[g][c][e], kv[u][c][e], d);
        for (int off = L / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        float v = d * scale;
        if (kQuant) v *= ksc[u];
        sc[u][g] = ok[u] ? v : REPRO_NEG_INF;
      }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][g]);
      const float corr = expf(m[g] - mx);
      float p[kUnroll], sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(sc[u][g] - mx) : 0.f;
        sum += p[u];
        // l takes the unscaled exp; the value weights carry v_scale
        if (kQuant) p[u] *= vsc[u];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = acc[g][c][e] * corr;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) x = fmaf(p[u], vv[u][c][e], x);
          acc[g][c][e] = x;
        }
    }
  }

  // merge the block's kWarps * R lane groups in group order
  const int n_states = kWarps * R;
  float* sm_m = smem;                            // [n_states][kG]
  float* sm_l = sm_m + n_states * kG;
  float* sm_acc = sm_l + n_states * kG;          // [n_states][kG][Dv]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (li == 0) {
      sm_m[gid * kG + g] = m[g];
      sm_l[gid * kG + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = 4 * (li + c * L);
      if (col < Dv)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm_acc[(gid * kG + g) * Dv + col + e] = acc[g][c][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * Dv; i += kThreads) {
    const int g = i / Dv, d = i - g * Dv;
    float M = REPRO_NEG_INF;
    for (int j = 0; j < n_states; ++j) M = fmaxf(M, sm_m[j * kG + g]);
    float ls = 0.f, acc_d = 0.f;
    for (int j = 0; j < n_states; ++j) {
      const float w = expf(sm_m[j * kG + g] - M);
      ls += sm_l[j * kG + g] * w;
      acc_d += sm_acc[(j * kG + g) * Dv + d] * w;
    }
    put_state(part, out, qrow0 + g, s, S, Dv, d, M, ls, acc_d);
  }
}

// The general path: one block per (kv head, slot, split) holds all grp
// query rows in shared memory and stages each live page of its split there
// as f32; the online softmax state (m, l, acc) lives in shared memory.
size_t general_smem_floats(int grp, int Dh, int Dv, int PS) {
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
decode_general_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const PT* __restrict__ k_pool = static_cast<const PT*>(a.k_pool);
  const PT* __restrict__ v_pool = static_cast<const PT*>(a.v_pool);
  const float* __restrict__ k_scale = a.k_scale;
  const float* __restrict__ v_scale = a.v_scale;
  const int Hkv = a.Hkv, grp = a.grp, Dh = a.Dh, Dv = a.Dv, PS = a.PS;
  const int P = a.P, pps = a.pps;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
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

  const size_t qrow0 = ((size_t)b * Hkv + h) * grp;
  const float* qb = a.q + qrow0 * Dh;
  for (int i = tid; i < grp * Dh; i += kThreads) q_s[i] = qb[i];
  for (int i = tid; i < grp * Dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < grp; i += kThreads) {
    m_s[i] = REPRO_NEG_INF;
    l_s[i] = 0.f;
  }
  const int len = max(a.lengths[b], 0);
  const int live = min((len + PS - 1) / PS, P);
  const size_t k_row = (size_t)Hkv * Dh, v_row = (size_t)Hkv * Dv;
  __syncthreads();

  for (int p = s * pps; p < min(live, (s + 1) * pps); ++p) {
    const size_t page = (size_t)a.table[(size_t)b * P + p];
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
      float sc = REPRO_NEG_INF;
      if (p * PS + r < len) {
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d)
          dot = fmaf(q_s[g * Dh + d], k_s[r * ldk + d], dot);
        sc = dot * a.scale;
        if (kQuant) sc *= ks_s[r];
      }
      p_s[i] = sc;
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
      float x = acc[i] * c_s[g];
      for (int r = 0; r < PS; ++r) x = fmaf(p_s[g * PS + r], v_s[r * ldv + d], x);
      acc[i] = x;
    }
    __syncthreads();
  }

  for (int i = tid; i < grp * Dv; i += kThreads) {
    const int g = i / Dv;
    put_state(a.part, a.out, qrow0 + g, s, S, Dv, i - g * Dv, m_s[g], l_s[g],
              acc[i]);
  }
}

// out[row] = the split-order reduction of the S partial states of `row`.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part, float* __restrict__ out,
               int S, int Dv) {
  const size_t row = blockIdx.x;
  const float* p = part + row * S * (size_t)(2 + Dv);
  float M = REPRO_NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, p[(size_t)s * (2 + Dv)]);
  float l = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* ps = p + (size_t)s * (2 + Dv);
    l += ps[1] * expf(ps[0] - M);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < Dv; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ps = p + (size_t)s * (2 + Dv);
      a += ps[2 + d] * expf(ps[0] - M);
    }
    out[row * Dv + d] = a * inv;
  }
}

// Lanes per row: the smallest power of two that covers the wider of Dh and
// Dv in kNC slices of 4 per lane.
int lanes_per_row(int Dh, int Dv, int nc) {
  const int per = ((std::max(Dh, Dv) + 3) / 4 + nc - 1) / nc;
  int L = 1;
  while (L < per) L *= 2;
  return L;
}

template <typename PT, int kG, int kNC>
cudaError_t launch_split(const Args& a, cudaStream_t stream) {
  const int L = lanes_per_row(a.Dh, a.Dv, kNC);
  const size_t n_states = kWarps * (32 / L);
  const size_t smem = sizeof(float) * n_states * kG * (2 + (size_t)a.Dv);
  cudaError_t err = reserve_smem(decode_split_kernel<PT, kG, kNC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv * ((a.grp + kG - 1) / kG), a.B, a.S);
  decode_split_kernel<PT, kG, kNC><<<grid, kThreads, smem, stream>>>(a, L);
  return cudaGetLastError();
}

template <typename PT, int kNC>
cudaError_t launch_nc(const Args& a, cudaStream_t stream) {
  if (a.grp <= 1) return launch_split<PT, 1, kNC>(a, stream);
  if (a.grp <= 2) return launch_split<PT, 2, kNC>(a, stream);
  if (a.grp <= 4) return launch_split<PT, 4, kNC>(a, stream);
  return launch_split<PT, kMaxG, kNC>(a, stream);
}

template <typename PT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // the register path reads 4 elements per load: widths that are multiples
  // of 4 and pools aligned to 4 elements (then every row is)
  const uintptr_t align = 4 * sizeof(PT);
  const bool vec = a.Dh % 4 == 0 && a.Dv % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.k_pool) % align == 0 &&
                   reinterpret_cast<uintptr_t>(a.v_pool) % align == 0;
  const int width = std::max(a.Dh, a.Dv);
  cudaError_t err;
  if (vec && width <= 128) {
    err = launch_nc<PT, 1>(a, stream);
  } else if (vec && width <= 256) {
    err = launch_nc<PT, 2>(a, stream);
  } else {
    const size_t smem =
        sizeof(float) * general_smem_floats(a.grp, a.Dh, a.Dv, a.PS);
    err = reserve_smem(decode_general_kernel<PT>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.Hkv, a.B, a.S);
    decode_general_kernel<PT><<<grid, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || a.S == 1) return err;
  combine_kernel<<<a.B * a.Hkv * a.grp, kThreads, 0, stream>>>(a.part, a.out,
                                                              a.S, a.Dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gqa_paged_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, int pool_dtype,
                                      const void* table, const void* lengths,
                                      void* part, void* out, int B, int Hkv,
                                      int grp, int Dh, int Dv, int PS, int P,
                                      int S, int pps, float scale,
                                      void* stream) {
  const Args a{static_cast<const float*>(q), k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(table),
               static_cast<const int*>(lengths), static_cast<float*>(part),
               static_cast<float*>(out), B, Hkv, grp, Dh, Dv, PS, P, S, pps,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || pps < 1 || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_dtype == kF32) return launch<float>(a, st);
  if (pool_dtype == kBF16) return launch<__nv_bfloat16>(a, st);
  if (pool_dtype == kI8) {
    if (k_scale == nullptr || v_scale == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<int8_t>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
