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
//   rows    i32 [E] or null     live rows per expert: rows >= rows[e] come
//                               out zero and expert e's weights are read
//                               only if rows[e] > 0 (read on the device)
//   y       Y    [E, C, Co]     Y = the activations' type (f32 or bf16)
//   part    f32  [splits, E, C, Co] split-K partials (splits > 1 only)
//
// Arithmetic, as the oracle ref.w4a8_grouped_ref: B5's, per expert — the
// weight codes folded to clip(code - round(zero), -128, 127), one exact
// int32 sum per (row, group), scaled by the group's weight scale into f32,
// and the row's activation scale applied at the end.  A zero row has zero
// codes and so an exact zero output row.
//
// What bounds it on an H100: at prefill capacities the int8 multiply-adds
// of the filled rows, 2 * rows * Ci * Co operations at the int8
// tensor-core rate (1,979 TOP/s), or the live experts' packed weight bytes
// at 3.35 TB/s, whichever is larger (granite's 512x1024 experts at C=160:
// the bytes).
//
// Design: B5's tile (w4a8_tile.cuh: int8 mma.sync on zero-folded codes
// built in registers, the shared cp.async ring and split-K) with the
// expert as grid axis z (every operand offset to expert e in the block) and
// rows[e] read by each block: a block whose first row is at or past it
// reads nothing, so the capacity rows that no token filled cost no MMA and
// an idle expert no weight bytes.  Preconditions (checked by the wrapper):
// G % 8 == 0, Ci % G == 0, Co % 4 == 0.

#include "w4a8_tile.cuh"

extern "C" int repro_w4a8_grouped(const void* xq, const void* xs,
                                  const void* packed, const void* scales,
                                  const void* zeros, int s_dtype,
                                  const void* rows, void* y, int y_dtype,
                                  void* part, int E, int C, int Ci, int Co,
                                  int G, int tile, int splits, void* stream) {
  return w4tc::launch_a8(xq, xs, packed, scales, zeros, s_dtype,
                         static_cast<const int*>(rows), y, y_dtype,
                         static_cast<float*>(part), E, C, Ci, Co, G, tile,
                         splits, stream);
}
