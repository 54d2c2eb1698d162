// B5: W4A8 group-wise GEMM for prefill, Y[T,Co] = X[T,Ci] @ W[Ci,Co] with
// per-token int8 activations.
//
// Replaces the Pallas TPU kernel repro/kernels/w4a16_matmul.py:_kernel_a8
// with its block expansion _dequant_block_i8 (entry w4a16_matmul(act="a8"),
// pallas_call at w4a16_matmul.py:207).
//
//   xq      int8 [T, Ci]       per-token symmetric activation codes
//   xs      f32  [T]           their scales (x ~= xq * xs)
//   packed  u8   [Ci/2, Co]    int4 codes, group-split: within each group of
//                              G rows, packed row r holds row r in the low
//                              nibble and row G/2 + r in the high nibble
//   scales  S    [Ci/G, Co]    S = f32 or bf16
//   zeros   S    [Ci/G, Co]    integer-valued zero points
//   y       Y    [T, Co]       Y = the activations' type (f32 or bf16)
//
// Arithmetic, as the reference oracle ref.w4a8_matmul_ref: each weight code
// is folded to the int8 value clip(code - round(zero), -128, 127); for each
// (token, group) an exact int32 sum of xq * folded code is taken over the
// group's G rows only, then acc += part * scale[g, co] in f32; finally
// y = acc * xs[t].
//
// What bounds it on an H100: at prefill sizes (T in the hundreds) the
// int8 multiply-adds, 2*T*Ci*Co operations.  This first kernel issues them
// as __dp4a on the CUDA cores, not on the int8 tensor cores (mma/wgmma is
// later work), so it sits far above the 1,979 TOPS tensor-core bound.
//
// Design: K1's layout (csrc/w4a16_matmul.cu).  A block owns 64 columns
// (16 column lanes x 4 columns, one uint32 of 4 packed bytes per read) and
// 8 tokens; its 8 k-splits (rows of 16 threads) take quantization groups
// round-robin, so an int32 partial sum never spans two groups.  A k-split
// stages its group's [8, G] activation codes in shared memory.  A lane reads
// four consecutive packed rows r..r+3 of its 4 columns (four uint32 words),
// transposes the 4x4 bytes with __byte_perm so that each column's word holds
// rows r..r+3, splits the nibbles (low = k-codes r..r+3, high = G/2+r..),
// folds the zero point per byte with two signed-saturating subtractions
// (__vsubss4 by clamp(z) then by clamp(z - clamp(z)), which is exactly the
// reference's clip to [-128, 127] for any integer z), and takes __dp4a
// against the matching 4-code words of each token.  The k-split sums are
// reduced through shared memory once at the end.  Preconditions (checked by
// the wrapper): G % 8 == 0, Ci % G == 0, Co % 4 == 0.
// The tile body is w4::a8_tile in common.cuh, shared with the grouped
// (stacked-expert) kernel B7 in w4a8_grouped.cu.

#include "common.cuh"

namespace {

using w4::kBlockCo;
using w4::kThreads;
using w4::kTTile;

template <typename ST, typename YT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
            const ST* __restrict__ zeros, YT* __restrict__ y, int T, int Ci,
            int Co, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  w4::a8_tile<ST, YT>(xq, xs, packed, scales, zeros, y, T, Ci, Co, G,
                      blockIdx.x, blockIdx.y, smem_raw);
}

template <typename ST, typename YT>
cudaError_t launch(const int8_t* xq, const float* xs, const uint8_t* packed,
                   const void* scales, const void* zeros, void* y, int T,
                   int Ci, int Co, int G, cudaStream_t stream) {
  const size_t smem = w4::a8_smem_bytes(G);
  cudaError_t err = reserve_smem(w4a8_kernel<ST, YT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Co + kBlockCo - 1) / kBlockCo, (T + kTTile - 1) / kTTile);
  w4a8_kernel<ST, YT><<<grid, kThreads, smem, stream>>>(
      xq, xs, packed, static_cast<const ST*>(scales),
      static_cast<const ST*>(zeros), static_cast<YT*>(y), T, Ci, Co, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_w4a8_matmul(const void* xq, const void* xs,
                                 const void* packed, const void* scales,
                                 const void* zeros, int s_dtype, void* y,
                                 int y_dtype, int T, int Ci, int Co, int G,
                                 void* stream) {
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_dtype == kF32 && y_dtype == kF32)
    return launch<float, float>(x, s, p, scales, zeros, y, T, Ci, Co, G, st);
  if (s_dtype == kF32 && y_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, s, p, scales, zeros, y, T, Ci, Co,
                                        G, st);
  if (s_dtype == kBF16 && y_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, s, p, scales, zeros, y, T, Ci, Co,
                                        G, st);
  if (s_dtype == kBF16 && y_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, s, p, scales, zeros, y, T,
                                                 Ci, Co, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
