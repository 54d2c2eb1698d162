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
// What bounds it on an H100: the score and value FLOPs, 4 * D per (query,
// key) pair (half the pairs when causal), on the CUDA cores in f32 (67
// TFLOP/s) — this first kernel does not use the tensor cores.  The bytes
// (q, k, v read once, out written once) are far below that at T >= 64.
//
// Design: K3's scheme (csrc/gqa_paged_prefill.cu) without the page table.
// One block per (tile of 64 rows of the flattened T*grp query axis, KV
// head, batch), so the grp query heads of one KV head share each staged K/V
// tile.  The block walks key tiles of 64 from key 0 up to the last row's
// time index, which skips every tile strictly above the causal diagonal.
// 256 threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and
// keys tx + 16 j (i, j < 4) of each 64 x 64 score tile in registers, the
// row max and sum are reduced across the 16 threads of a half warp with
// shuffles, and it owns output columns tx + 16 c of its 4 rows (acc in
// registers, D / 16 each).  D is a run-time argument, dispatched to
// instances for D in {16, 32, 64, 128}.

#include "common.cuh"

namespace {

constexpr int kRows = 64;     // query rows (of the flattened T*grp axis)
constexpr int kKeys = 64;     // keys per tile
constexpr int kTx = 16;
constexpr int kThreads = kTx * kTx;  // 256
constexpr int kPer = kRows / kTx;    // rows (and keys) per thread: 4

template <int kD>
size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (kD + 1)      // q rows
                          + (size_t)kKeys * (kD + 1)    // K tile
                          + (size_t)kKeys * kD          // V tile
                          + (size_t)kRows * (kKeys + 1));  // probabilities
}

template <typename XT, int kD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const XT* __restrict__ q, const XT* __restrict__ k,
             const XT* __restrict__ v, XT* __restrict__ out, int Tq, int S,
             int Hkv, int grp, float scale, int causal) {
  constexpr int ldq = kD + 1, ldk = kD + 1, ldp = kKeys + 1;
  constexpr int kDC = kD / kTx;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * ldq;
  float* vs = ks + kKeys * ldk;
  float* ps = vs + kKeys * kD;

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int R0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * grp;
  const int nrows = min(kRows, Tq * grp - R0);

  // this block's query rows: flattened row R is time R / grp, head
  // h * grp + R % grp
  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int rr = i / kD, d = i - rr * kD;
    float val = 0.f;
    if (rr < nrows) {
      const int R = R0 + rr, t = R / grp, g = R - t * grp;
      val = to_f32(q[(((size_t)b * Tq + t) * H + h * grp + g) * kD + d]);
    }
    qs[rr * ldq + d] = val;
  }

  int rt[kPer];  // time index of each owned row (-1 past the end)
  float m[kPer], l[kPer], acc[kPer][kDC];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kTx * i;
    rt[i] = r < nrows ? (R0 + r) / grp : -1;
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }
  const int t_last = (R0 + nrows - 1) / grp;
  const int kv_end = causal ? min(t_last + 1, S) : S;
  const size_t kv_row = (size_t)Hkv * kD;
  const XT* kb = k + (size_t)b * S * kv_row + (size_t)h * kD;
  const XT* vb = v + (size_t)b * S * kv_row + (size_t)h * kD;

  for (int j0 = 0; j0 < kv_end; j0 += kKeys) {
    __syncthreads();  // the previous tile's reads of ks / vs / ps are done
    for (int i = tid; i < kKeys * kD; i += kThreads) {
      const int r = i / kD, d = i - r * kD;
      const bool ok = j0 + r < S;
      const size_t off = (size_t)(j0 + r) * kv_row + d;
      ks[r * ldk + d] = ok ? to_f32(kb[off]) : 0.f;
      vs[r * kD + d] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; ++d) {
      float a[kPer], w[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = qs[(ty + kTx * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) w[j] = ks[(tx + kTx * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) s[i][j] = fmaf(a[i], w[j], s[i][j]);
    }

    // masked online softmax; the 16 threads sharing a row are one half warp
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int key = j0 + tx + kTx * j;
        const bool valid = rt[i] >= 0 && key < S && (!causal || key <= rt[i]);
        s[i][j] = valid ? s[i][j] * scale : REPRO_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p =
            s[i][j] == REPRO_NEG_INF ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        ps[(ty + kTx * i) * ldp + tx + kTx * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      float vv[kDC];
#pragma unroll
      for (int dd = 0; dd < kDC; ++dd) vv[dd] = vs[c * kD + tx + kTx * dd];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float p = ps[(ty + kTx * i) * ldp + c];
#pragma unroll
        for (int dd = 0; dd < kDC; ++dd) acc[i][dd] = fmaf(p, vv[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (rt[i] < 0) continue;
    const int R = R0 + ty + kTx * i, t = rt[i], g = R - t * grp;
    XT* o = out + (((size_t)b * Tq + t) * H + h * grp + g) * kD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDC; ++dd) store_as(&o[tx + kTx * dd], acc[i][dd] / den);
  }
}

template <typename XT, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int S, int Hkv, int grp, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<kD>();
  cudaError_t err = reserve_smem(flash_kernel<XT, kD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq * grp + kRows - 1) / kRows, Hkv, B);
  flash_kernel<XT, kD><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(q), static_cast<const XT*>(k),
      static_cast<const XT*>(v), static_cast<XT*>(out), Tq, S, Hkv, grp,
      scale, causal);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int Tq, int S, int Hkv, int grp, int D,
                     float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<XT, 16>(q, k, v, out, B, Tq, S, Hkv, grp, scale, causal,
                            stream);
    case 32:
      return launch<XT, 32>(q, k, v, out, B, Tq, S, Hkv, grp, scale, causal,
                            stream);
    case 64:
      return launch<XT, 64>(q, k, v, out, B, Tq, S, Hkv, grp, scale, causal,
                            stream);
    case 128:
      return launch<XT, 128>(q, k, v, out, B, Tq, S, Hkv, grp, scale, causal,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int Tq, int S, int Hkv, int grp,
                                     int D, float scale, int causal,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_d<float>(q, k, v, out, B, Tq, S, Hkv, grp, D, scale, causal,
                           s);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Tq, S, Hkv, grp, D, scale,
                                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
