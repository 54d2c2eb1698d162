// B6: grouped (stacked-expert) W4A16 GEMM,
// Y[E, C, Co] = X[E, C, Ci] @ W[E, Ci, Co], one independent product per
// expert e.
//
// Replaces the Pallas TPU kernel repro/kernels/w4a16_grouped.py:_kernel
// (entry w4a16_grouped_matmul, pallas_call at w4a16_grouped.py:165), the
// MoE expert contraction of repro/models/mlp.py:_expert_matmul.
//
//   x       X  [E, C, Ci]       per-expert capacity rows (f32 or bf16)
//   packed  u8 [E, Ci/2, Co]    int4 codes in the group-split layout of K1
//   scales  S  [E, Ci/G, Co]    S = f32 or bf16
//   zeros   S  [E, Ci/G, Co]    integer-valued zero points
//   rows    i32 [E] or null     live rows per expert: rows >= rows[e] come
//                               out zero and expert e's weights are read
//                               only if rows[e] > 0 (read on the device)
//   y       X  [E, C, Co]       f32 sums, stored in X's type
//
// What bounds it on an H100: at decode (C = top_k rows per expert, the
// capacity floor) it is a batch of E small GEMVs and the live experts'
// packed weight bytes bound it at 3.35 TB/s: with `rows`, an expert no
// token was routed to costs nothing (path 4 decode: at most 24 of 160
// experts are live).  At prefill capacities (hundreds of rows) the
// tensor-core operations bound it (2*rows*Ci*Co at 989 TFLOP/s; the tile
// pays them three times for f32 X, split in three bf16 terms).
//
// Design: the tile of w4a16_tile.cuh with the expert as grid axis z (every
// operand offset to expert e in the block), rows[e] read by each block;
// split-K over quantization groups when E x column tiles is small; any
// G % 8 == 0 through the chunked ring of w4_ring.cuh.  A zero
// capacity row yields an exact zero output row whatever the zero points
// (its P and group sums are exact zeros).

#include "w4a16_tile.cuh"

extern "C" int repro_w4a16_grouped(const void* x, int x_dtype,
                                   const void* packed, const void* scales,
                                   const void* zeros, int s_dtype,
                                   const void* rows, void* y, void* part,
                                   int E, int C, int Ci, int Co, int G,
                                   int tile, int splits, void* stream) {
  return w4tc::launch(x, x_dtype, packed, scales, zeros, s_dtype,
                      static_cast<const int*>(rows), y,
                      static_cast<float*>(part), E, C, Ci, Co, G, tile,
                      splits, stream);
}
