// B7: grouped (stacked-expert) W4A8 GEMM for prefill,
// Y[E, C, Co] = X[E, C, Ci] @ W[E, Ci, Co] with per-(expert, row) int8
// activations.
//
// Replaces the Pallas TPU kernel repro/kernels/w4a16_grouped.py:_kernel_a8
// with its block expansion w4a16_matmul.py:_dequant_block_i8 (entry
// w4a16_grouped_matmul(act="a8"), pallas_call at w4a16_grouped.py:165).
//
//   xq      int8 [E, C, Ci]     per-row symmetric activation codes (the
//                               wrapper quantizes; zero capacity rows give
//                               zero codes)
//   xs      f32  [E, C]         their scales
//   packed  u8   [E, Ci/2, Co]  int4 codes, group-split layout
//   scales  S    [E, Ci/G, Co]  S = f32 or bf16
//   zeros   S    [E, Ci/G, Co]  integer-valued zero points
//   y       Y    [E, C, Co]     Y = the activations' type (f32 or bf16)
//
// Arithmetic, as the oracle ref.w4a8_grouped_ref: B5's, per expert — the
// weight codes folded to clip(code - round(zero), -128, 127), one exact
// int32 sum per (row, group), scaled by the group's weight scale into f32,
// and the row's activation scale applied at the end.  A zero row has zero
// codes and so an exact zero output row.
//
// What bounds it on an H100: at prefill capacities the int8 multiply-adds,
// 2 * E * C * Ci * Co operations; issued as __dp4a on the CUDA cores (not
// the int8 tensor cores), so far above the tensor-core bound.
//
// Design: B5's tile (w4::a8_tile in common.cuh) with the expert as the
// outermost grid axis, blockIdx.y = e * row_tiles + row_tile, and every
// operand offset to expert e before the tile runs.  Preconditions (checked
// by the wrapper): G % 8 == 0, Ci % G == 0, Co % 4 == 0.

#include "common.cuh"

namespace {

using w4::kBlockCo;
using w4::kThreads;
using w4::kTTile;

template <typename ST, typename YT>
__global__ void __launch_bounds__(kThreads)
w4a8_grouped_kernel(const int8_t* __restrict__ xq,
                    const float* __restrict__ xs,
                    const uint8_t* __restrict__ packed,
                    const ST* __restrict__ scales,
                    const ST* __restrict__ zeros, YT* __restrict__ y, int C,
                    int Ci, int Co, int G, int row_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.y / row_tiles;
  const int tile = blockIdx.y - e * row_tiles;
  const size_t sz = (size_t)(Ci / G) * Co;
  w4::a8_tile<ST, YT>(xq + (size_t)e * C * Ci, xs + (size_t)e * C,
                      packed + (size_t)e * (Ci / 2) * Co, scales + e * sz,
                      zeros + e * sz, y + (size_t)e * C * Co, C, Ci, Co, G,
                      blockIdx.x, tile, smem_raw);
}

template <typename ST, typename YT>
cudaError_t launch(const int8_t* xq, const float* xs, const uint8_t* packed,
                   const void* scales, const void* zeros, void* y, int E,
                   int C, int Ci, int Co, int G, cudaStream_t stream) {
  const size_t smem = w4::a8_smem_bytes(G);
  cudaError_t err = reserve_smem(w4a8_grouped_kernel<ST, YT>, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (C + kTTile - 1) / kTTile;
  dim3 grid((Co + kBlockCo - 1) / kBlockCo, E * row_tiles);
  w4a8_grouped_kernel<ST, YT><<<grid, kThreads, smem, stream>>>(
      xq, xs, packed, static_cast<const ST*>(scales),
      static_cast<const ST*>(zeros), static_cast<YT*>(y), C, Ci, Co, G,
      row_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_w4a8_grouped(const void* xq, const void* xs,
                                  const void* packed, const void* scales,
                                  const void* zeros, int s_dtype, void* y,
                                  int y_dtype, int E, int C, int Ci, int Co,
                                  int G, void* stream) {
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_dtype == kF32 && y_dtype == kF32)
    return launch<float, float>(x, s, p, scales, zeros, y, E, C, Ci, Co, G,
                                st);
  if (s_dtype == kF32 && y_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, s, p, scales, zeros, y, E, C, Ci,
                                        Co, G, st);
  if (s_dtype == kBF16 && y_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, s, p, scales, zeros, y, E, C, Ci,
                                        Co, G, st);
  if (s_dtype == kBF16 && y_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, s, p, scales, zeros, y, E,
                                                 C, Ci, Co, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
