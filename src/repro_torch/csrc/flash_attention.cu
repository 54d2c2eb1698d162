// B4: flash attention over a full sequence, causal or not, with GQA head
// mapping: out[B, T, H, D] = softmax(q k^T * D^-0.5 [+ causal mask]) v.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_kernel
// (entry flash_attention, pallas_call at flash_attention.py:119), reached
// through cfg.attn_impl = "flash" (models/attention.py:_full_attention):
// the calibration passes of quantize-on-load and the teacher-forced
// forward.
//
//   q    X [B, T, H, D]      X = f32 or bf16; query head h reads KV head
//   k    X [B, S, Hkv, D]    h / grp (grp = H / Hkv), with no repeat in
//   v    X [B, S, Hkv, D]    memory
//   out  X [B, T, H, D]      f32 softmax state, stored in X's type
//
// Masks, as the reference: key j is valid for query t when j < S and, when
// causal, j <= t (index positions, as the Pallas kernel's iotas).  The
// online softmax keeps f32 m, l and acc per query row and ends with
// acc / max(l, 1e-30).  Masked scores take -1e30 and weigh exactly 0.
//
// What bounds it on an H100: the score and value products, 4 * D
// operations per (query, key) pair (half the pairs when causal), on the
// tensor cores; the bytes (q, k, v read once, out written once) are far
// below that at T >= 64.
//
// Design: the tensor-core tile of attn_tile.cuh, K3's, without the page
// table.  B4's q is K3's q[B, T, Hkv, grp, D] and its k/v are K3's chunk
// K/V, so a block is one (64 rows of the flattened T*grp axis, KV head,
// slice of <= kDV value columns, batch): 4 warps of 16 rows, the grp query
// heads of one KV head sharing every staged K/V tile; 64-key tiles of
// contiguous K/V stream through the cp.async ring (two stages where two
// blocks fit on an SM, else one).  Causal: the block's keys end at min(t of
// its last row + 1, S), so keys at or past T are never read when S > T; a
// warp skips the tiles above its rows' diagonal and the diagonal tile is
// masked per row (t = R / grp: with grp > 1 a warp's 16 rows span several
// time steps); the row tiles are the slowest grid axis, launched last
// first, so the longest tiles of every head start in the first wave.
// Non-causal: every key below S is valid (the tile's prefix-style mask, a
// compile-time choice).  f32 q/k/v: 3xTF32 products on m16n8k8, as K3.
// bf16: Q stays bf16 in shared memory, so S = Q K^T is one bf16 m16n8k16
// MMA per k-step (fragments by ldmatrix), and P (f32) meets V in
// kBf16QPTerms bf16 terms.  The tile's kFast options: tiles wholly below a
// row's diagonal skip the masks and the softmax runs in base 2 (ex2).  f32
// P.V sums 32-key groups in fresh accumulators, as in K3 (one accumulator
// over 2048 keys drifts past the 1e-5 tolerance: the MMAs truncate).
//
// The CUDA-core path, for head widths whose tile does not fit one ring
// stage in shared memory (f32 D > 384, bf16 D > 832, repro_flash_attention
// _route): one warp per flattened query row, its q row and f32 acc in
// shared memory, the keys in order with one online-softmax step each (lane
// d-strided dot products, reduced by shuffles).

#include <algorithm>

#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace attn_tc;

constexpr int kGenWarps = 4;   // CUDA-core path: query rows per block

template <typename XT, bool kCausal, int kDV>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
                const XT* __restrict__ v, XT* __restrict__ out, int S,
                const Geo G) {
  constexpr int kNT = kDV / 8;
  constexpr int es = (int)sizeof(XT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int rt = kCausal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.z;
  const int R0 = rt * kRows;
  const int h = blockIdx.x / G.n_vs;
  const int v0 = (blockIdx.x - h * G.n_vs) * kDV;
  const int b = blockIdx.y;
  const int TG = G.T * G.grp, H = G.Hkv * G.grp;
  const int nrows = min(kRows, TG - R0);
  const int vw = min(kDV, G.Dv - v0);
  const int kv_end = kCausal ? min((R0 + nrows - 1) / G.grp + 1, S) : S;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const size_t kv_row = (size_t)G.Hkv * G.Dh;
  const int ldq = G.Dhp + 16 / es;       // rows 16 bytes apart past Dhp
  const XT* qs = reinterpret_cast<const XT*>(smem);
  unsigned char* ring = smem + (size_t)kRows * ldq * es;
  const XT* kb = k + (size_t)b * S * kv_row + (size_t)h * G.Dh;
  const XT* vb = v + (size_t)b * S * kv_row + (size_t)h * G.Dv + v0;

  stage_rows(smem, ldq * es, kRows, G.Dh * es, G.Dhp * es, G.pq, q,
             [&](int r) -> const unsigned char* {
               const int R = R0 + r;
               if (R >= TG) return nullptr;
               const int t = R / G.grp;
               return reinterpret_cast<const unsigned char*>(
                   q + (((size_t)b * G.T + t) * H + (size_t)h * G.grp +
                        (R - t * G.grp)) * G.Dh);
             });

  // stage key tile i into ring stage st
  auto issue = [&](int i, int st) {
    unsigned char* kd = ring + (size_t)st * G.stage_bytes;
    unsigned char* vd = kd + kKeys * G.ldk;
    const int j0 = i * kKeys;
    stage_rows(kd, G.ldk, kKeys, G.Dh * es, G.Dhp * es, G.pks, k,
               [&](int r) -> const unsigned char* {
                 const int j = j0 + r;
                 return j >= kv_end ? nullptr
                                    : reinterpret_cast<const unsigned char*>(
                                          kb + (size_t)j * kv_row);
               });
    stage_rows(vd, G.ldv, kKeys, vw * es, kDV * es, G.pvs, v,
               [&](int r) -> const unsigned char* {
                 const int j = j0 + r;
                 return j >= kv_end ? nullptr
                                    : reinterpret_cast<const unsigned char*>(
                                          vb + (size_t)j * kv_row);
               });
  };

  if (n_tiles > 0) issue(0, 0);
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = 16 * warp;                        // the warp's first row
  const bool live = wr < nrows;                    // it holds a query row
  const int ta = (R0 + wr + g) / G.grp;            // time of row g
  const int tb = (R0 + wr + g + 8) / G.grp;        // and of row g + 8
  const int t_warp = (R0 + wr + 15) / G.grp;       // of the warp's last row
  const XT* qw = qs + wr * ldq;
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
    const int j0 = i * kKeys;
    // a causal tile above this warp's diagonal has no valid key
    if (live && (!kCausal || j0 <= t_warp))
      tile_step<XT, !kCausal, false, kNT, XT, true>(
          o, m, lp, qw, ldq, kd, kd + kKeys * G.ldk, nullptr, nullptr, G, j0,
          S, ta, tb, g, tq);
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
    XT* orow = out + (((size_t)b * G.T + t) * H + (size_t)h * G.grp +
                      (R - t * G.grp)) * G.Dv + v0;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int c = 8 * n + 2 * tq;
      if (c < vw) store_as(orow + c, o[n][2 * r] / den);
      if (c + 1 < vw) store_as(orow + c + 1, o[n][2 * r + 1] / den);
    }
  }
}

// ------------------------------------------------------- CUDA-core path
template <typename XT, bool kCausal>
__global__ void __launch_bounds__(32 * kGenWarps)
flash_general_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
                     const XT* __restrict__ v, XT* __restrict__ out, int T,
                     int S, int Hkv, int grp, int D, float scale) {
  extern __shared__ float gsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int R = blockIdx.x * (blockDim.x / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (R >= T * grp) return;                // no block-wide barrier below
  float* qs = gsm + (size_t)warp * 2 * D;
  float* acc = qs + D;
  const int t = R / grp;
  const size_t row = (((size_t)b * T + t) * Hkv * grp + (size_t)h * grp +
                      (R - t * grp)) * D;
  for (int d = lane; d < D; d += 32) {   // lane-private columns throughout
    qs[d] = to_f32(q[row + d]);
    acc[d] = 0.f;
  }
  const size_t kv_row = (size_t)Hkv * D;
  const XT* kb = k + (size_t)b * S * kv_row + (size_t)h * D;
  const XT* vb = v + (size_t)b * S * kv_row + (size_t)h * D;
  const int kv_end = kCausal ? min(t + 1, S) : S;   // keys past it: weight 0
  float m = REPRO_NEG_INF, l = 0.f;
  for (int j = 0; j < kv_end; ++j) {
    const XT* kr = kb + (size_t)j * kv_row;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = fmaf(qs[d], to_f32(kr[d]), dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float s = dot * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new), p = expf(s - m_new);
    l = l * corr + p;
    m = m_new;
    const XT* vr = vb + (size_t)j * kv_row;
    for (int d = lane; d < D; d += 32)
      acc[d] = fmaf(p, to_f32(vr[d]), acc[d] * corr);
  }
  const float den = fmaxf(l, 1e-30f);
  for (int d = lane; d < D; d += 32) store_as(&out[row + d], acc[d] / den);
}

// ----------------------------------------------------------------- launch
// The tile's geometry for head width D and element size es (pieces from the
// operands' addresses where given); stages 0: the tile does not fit.
Geo make_geo(int es, int T, int Hkv, int grp, int D, float scale,
             size_t* q_bytes, const void* q = nullptr,
             const void* k = nullptr, const void* v = nullptr) {
  const int kdv = D <= 64 ? 64 : 128;
  Geo G{};
  G.T = T;
  G.Hkv = Hkv;
  G.grp = grp;
  G.Dh = D;
  G.Dv = D;
  G.Dhp = (D + 15) / 16 * 16;
  G.n_vs = (D + kdv - 1) / kdv;
  G.ldk = G.Dhp * es + 16;
  G.ldv = kdv * es + 16;
  G.stage_bytes = kKeys * (G.ldk + G.ldv);
  G.pq = piece_for(q, (size_t)D * es, es);
  G.pks = piece_for(k, (size_t)D * es, es);
  G.pvs = piece_for(v, (size_t)D * es, es);
  G.scale = scale;
  *q_bytes = (size_t)kRows * (G.Dhp * es + 16);
  G.stages = ring_stages(*q_bytes, G.stage_bytes);
  return G;
}

// the CUDA-core path's rows per block for width D (0: its row does not fit)
int general_warps(int D) {
  return (int)std::min<size_t>(kGenWarps, kMaxSmem / (8 * (size_t)D));
}

template <typename XT, bool kCausal, int kDV>
cudaError_t launch_tc(const XT* q, const XT* k, const XT* v, XT* out, int B,
                      int S, const Geo& G, size_t q_bytes,
                      cudaStream_t stream) {
  const size_t smem = q_bytes + (size_t)G.stages * G.stage_bytes;
  cudaError_t err = reserve_smem(flash_tc_kernel<XT, kCausal, kDV>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(G.Hkv * G.n_vs, B, (G.T * G.grp + kRows - 1) / kRows);
  flash_tc_kernel<XT, kCausal, kDV><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, G);
  return cudaGetLastError();
}

template <typename XT, bool kCausal>
cudaError_t launch(const void* q_v, const void* k_v, const void* v_v,
                   void* out_v, int B, int T, int S, int Hkv, int grp, int D,
                   float scale, cudaStream_t stream) {
  const XT* q = static_cast<const XT*>(q_v);
  const XT* k = static_cast<const XT*>(k_v);
  const XT* v = static_cast<const XT*>(v_v);
  XT* out = static_cast<XT*>(out_v);
  size_t q_bytes;
  const Geo G = make_geo((int)sizeof(XT), T, Hkv, grp, D, scale, &q_bytes, q,
                         k, v);
  if (G.stages > 0) {
    if (D <= 64)
      return launch_tc<XT, kCausal, 64>(q, k, v, out, B, S, G, q_bytes,
                                        stream);
    return launch_tc<XT, kCausal, 128>(q, k, v, out, B, S, G, q_bytes,
                                       stream);
  }
  const int warps = general_warps(D);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * 8 * D;
  cudaError_t err = reserve_smem(flash_general_kernel<XT, kCausal>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T * grp + warps - 1) / warps, Hkv, B);
  flash_general_kernel<XT, kCausal><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, out, T, S, Hkv, grp, D, scale);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       void* out, int B, int T, int S, int Hkv, int grp,
                       int D, float scale, int causal, cudaStream_t stream) {
  if (causal)
    return launch<XT, true>(q, k, v, out, B, T, S, Hkv, grp, D, scale,
                            stream);
  return launch<XT, false>(q, k, v, out, B, T, S, Hkv, grp, D, scale, stream);
}

int elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
}

}  // namespace

// 1 where head width D of element type `dtype` takes the tensor-core tile,
// 0 where the CUDA-core path, -1 where neither takes it (an unknown type,
// or a row too wide for the CUDA-core path's shared memory).
extern "C" int repro_flash_attention_route(int dtype, int D) {
  const int es = elem_bytes(dtype);
  if (es == 0 || D <= 0) return -1;
  size_t q_bytes;
  if (make_geo(es, 1, 1, 1, D, 1.f, &q_bytes).stages > 0) return 1;
  return general_warps(D) > 0 ? 0 : -1;
}

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int Tq, int S, int Hkv, int grp,
                                     int D, float scale, int causal,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_any<float>(q, k, v, out, B, Tq, S, Hkv, grp, D, scale,
                             causal, s);
  if (dtype == kBF16)
    return launch_any<__nv_bfloat16>(q, k, v, out, B, Tq, S, Hkv, grp, D,
                                     scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
