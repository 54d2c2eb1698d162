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
// What bounds it on an H100: at decode sizes (T <= batch) it is a GEMV and
// the packed weight bytes (Ci*Co/2 + scales + zeros) bound it at 3.35 TB/s.
// At prefill sizes the tensor-core operations bound it: 2*T*Ci*Co at
// 989 TFLOP/s.  The tile pays that once for bf16 X and three times for f32
// X (split in three bf16 terms), so f32 X sits at least 3x over the bound.
//
// Design: the tile of w4a16_tile.cuh with one "expert" (E = 1, no row
// counts): int4 codes centred at 8 into mma.sync bf16 MMAs with the group's
// zero and scale folded in f32 at the group's end, the cp.async ring of
// w4_ring.cuh (chunks of at most 128 weight rows, so any G % 8 == 0: a
// larger group walks several stages, a smaller one is padded to a whole
// k-step), split-K over quantization groups when the column tiles alone
// leave the SMs idle (decode: Co/128 blocks) or a block would walk many
// groups, 8-row tiles at decode and 64-row tiles at prefill.  The wrapper
// (kernels/w4a16_matmul.py) picks the tile and the split count and
// allocates the split partials.

#include "w4a16_tile.cuh"

extern "C" int repro_w4a16_matmul(const void* x, int x_dtype,
                                  const void* packed, const void* scales,
                                  const void* zeros, int s_dtype, void* y,
                                  void* part, int T, int Ci, int Co, int G,
                                  int tile, int splits, void* stream) {
  return w4tc::launch(x, x_dtype, packed, scales, zeros, s_dtype, nullptr, y,
                      static_cast<float*>(part), 1, T, Ci, Co, G, tile,
                      splits, stream);
}
