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
// The tile body is w4::a16_tile in common.cuh, shared with the grouped
// (stacked-expert) kernel B6 in w4a16_grouped.cu.

#include "common.cuh"

namespace {

using w4::kBlockCo;
using w4::kThreads;
using w4::kTTile;

template <typename XT, typename ST>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
             const ST* __restrict__ scales, const ST* __restrict__ zeros,
             XT* __restrict__ y, int T, int Ci, int Co, int G) {
  extern __shared__ float smem[];
  w4::a16_tile<XT, ST>(x, packed, scales, zeros, y, T, Ci, Co, G, blockIdx.x,
                       blockIdx.y, smem);
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const uint8_t* packed, const void* scales,
                   const void* zeros, void* y, int T, int Ci, int Co, int G,
                   cudaStream_t stream) {
  const size_t smem = w4::a16_smem_bytes(G);
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
