// K1: W4A16 group-wise dequant-inside-GEMM, Y[T,Co] = X[T,Ci] @ W[Ci,Co].
//
// Replaces the Pallas TPU kernel repro/kernels/w4a16_matmul.py:_kernel
// (entry w4a16_matmul, pallas_call at w4a16_matmul.py:207).
//
// W is int4 in the reference's group-split packing: packed[Ci/2, Co] uint8,
// within each quantization group of G rows packed row r holds row g*G+r in
// the low nibble and row g*G+G/2+r in the high nibble.  scales/zeros are
// [Ci/G, Co] (f32 or bf16); zeros are integer-valued floats, so
// W[k, c] = (code - zero[g, c]) * scale[g, c].  X is f32 or bf16; the sum is
// kept in f32 and cast to X's type on store.
//
// What bounds it on an H100: at decode sizes (T <= batch) this is a GEMV and
// the packed weight bytes (Ci*Co/2 + scales + zeros) dominate, so it is bound
// by HBM bytes (3.35 TB/s).  At prefill sizes the f32 FMAs on the CUDA cores
// dominate (67 TFLOP/s f32 peak) — this first kernel does not use the tensor
// cores (wgmma is later work).
//
// Design: a block owns a 64-column tile of Co (16 column lanes x 4 columns,
// each lane reading one uint32 = 4 packed bytes along the contiguous Co axis)
// and a tile of 8 tokens.  Its 8 k-splits (rows of 16 threads) take the
// quantization groups round-robin: each stages its group's X slice [8, G] in
// shared memory as f32, reads one scales/zeros row for the group, and
// accumulates 8 x 4 outputs in registers.  The k-split partial sums are
// reduced through shared memory once at the end.  The ragged Co edge is
// masked per thread (Co % 4 == 0 keeps a thread's 4 columns all-in or
// all-out); ragged T is masked by zero-filled X rows.

#include "common.cuh"

namespace {

constexpr int kColsPerThread = 4;
constexpr int kColLanes = 16;
constexpr int kBlockCo = kColLanes * kColsPerThread;  // 64 columns per block
constexpr int kSplits = 8;
constexpr int kTTile = 8;
constexpr int kThreads = kColLanes * kSplits;          // 128

size_t smem_bytes(int G) {
  return sizeof(float) * (size_t)kSplits * kTTile * (G + kBlockCo);
}

template <typename XT, typename ST>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
             const ST* __restrict__ scales, const ST* __restrict__ zeros,
             XT* __restrict__ y, int T, int Ci, int Co, int G) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kColLanes;
  const int ks = threadIdx.x / kColLanes;
  float* xs = smem + (size_t)ks * kTTile * G;                 // [kTTile][G]
  float* red = smem + (size_t)kSplits * kTTile * G;           // [kSplits][kTTile][kBlockCo]

  const int col0 = blockIdx.x * kBlockCo + lane * kColsPerThread;
  const int t0 = blockIdx.y * kTTile;
  const bool col_ok = col0 < Co;
  const int n_groups = Ci / G;
  const int half = G / 2;

  float acc[kTTile][kColsPerThread];
#pragma unroll
  for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[tt][j] = 0.f;

  for (int round = 0; round < n_groups; round += kSplits) {
    const int g = round + ks;
    __syncthreads();  // the previous round's reads of xs are finished
    if (g < n_groups) {
      for (int i = lane; i < kTTile * G; i += kColLanes) {
        const int tt = i / G, kk = i - tt * G;
        const int t = t0 + tt;
        xs[i] = t < T ? to_f32(x[(size_t)t * Ci + (size_t)g * G + kk]) : 0.f;
      }
    }
    __syncthreads();
    if (g < n_groups && col_ok) {
      float sc[kColsPerThread], zr[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        sc[j] = to_f32(scales[(size_t)g * Co + col0 + j]);
        zr[j] = to_f32(zeros[(size_t)g * Co + col0 + j]);
      }
      const uint8_t* prow = packed + (size_t)g * half * Co + col0;
#pragma unroll 4
      for (int r = 0; r < half; ++r) {
        const uint32_t word =
            __ldg(reinterpret_cast<const unsigned int*>(prow + (size_t)r * Co));
        float wlo[kColsPerThread], whi[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const uint32_t b = (word >> (8 * j)) & 0xFFu;
          wlo[j] = (static_cast<float>(b & 0xFu) - zr[j]) * sc[j];
          whi[j] = (static_cast<float>(b >> 4) - zr[j]) * sc[j];
        }
#pragma unroll
        for (int tt = 0; tt < kTTile; ++tt) {
          const float xl = xs[tt * G + r];
          const float xh = xs[tt * G + half + r];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            acc[tt][j] = fmaf(xl, wlo[j], acc[tt][j]);
            acc[tt][j] = fmaf(xh, whi[j], acc[tt][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      red[((size_t)ks * kTTile + tt) * kBlockCo + lane * kColsPerThread + j] =
          acc[tt][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kTTile * kBlockCo; i += kThreads) {
    const int tt = i / kBlockCo, c = i - tt * kBlockCo;
    const int t = t0 + tt, col = blockIdx.x * kBlockCo + c;
    if (t < T && col < Co) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kSplits; ++k)
        s += red[((size_t)k * kTTile + tt) * kBlockCo + c];
      store_as(&y[(size_t)t * Co + col], s);
    }
  }
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const uint8_t* packed, const void* scales,
                   const void* zeros, void* y, int T, int Ci, int Co, int G,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(G);
  cudaError_t err = reserve_smem(w4a16_kernel<XT, ST>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Co + kBlockCo - 1) / kBlockCo, (T + kTTile - 1) / kTTile);
  w4a16_kernel<XT, ST><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), packed, static_cast<const ST*>(scales),
      static_cast<const ST*>(zeros), static_cast<XT*>(y), T, Ci, Co, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_w4a16_matmul(const void* x, int x_dtype,
                                  const void* packed, const void* scales,
                                  const void* zeros, int s_dtype, void* y,
                                  int T, int Ci, int Co, int G, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && s_dtype == kF32)
    return launch<float, float>(x, p, scales, zeros, y, T, Ci, Co, G, s);
  if (x_dtype == kF32 && s_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, p, scales, zeros, y, T, Ci, Co, G, s);
  if (x_dtype == kBF16 && s_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, p, scales, zeros, y, T, Ci, Co, G, s);
  if (x_dtype == kBF16 && s_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, p, scales, zeros, y, T, Ci,
                                                 Co, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
