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
//   part    f32  [splits, T, Co] split-K partials (splits > 1 only)
//
// Arithmetic, as the reference oracle ref.w4a8_matmul_ref: each weight code
// is folded to the int8 value clip(code - round(zero), -128, 127); for each
// (token, group) an exact int32 sum of xq * folded code is taken over the
// group's G rows only, then acc += part * scale[g, co] in f32; finally
// y = acc * xs[t].
//
// What bounds it on an H100: at prefill sizes (B5 runs at T >= 16) the
// int8 multiply-adds, 2*T*Ci*Co operations at the int8 tensor-core rate
// (1,979 TOP/s); at the shortest chunks the packed weight bytes
// (Ci*Co/2 + scales + zeros at 3.35 TB/s).
//
// Design: the int8 tensor-core tile of w4a8_tile.cuh with one "expert"
// (E = 1, no row counts): the zero-folded codes built in registers as the
// A operand of mma.sync m16n8k32 s8 (so the int8 products run on the
// tensor cores, exact in int32), the int8 X tile as B, one fold into f32
// per group, a cp.async ring of packed chunks shared with K1/B6
// (w4_ring.cuh), 64-row tiles of 128 or 256 columns, and split-K over
// groups when the tiles leave the SMs idle (T <= 128 chunks).  The wrapper
// (kernels/w4a16_matmul.py) quantizes X, picks the tile and the split count
// and allocates the split partials.  Preconditions (checked by the
// wrapper): G % 8 == 0, Ci % G == 0, Co % 4 == 0.

#include "w4a8_tile.cuh"

extern "C" int repro_w4a8_matmul(const void* xq, const void* xs,
                                 const void* packed, const void* scales,
                                 const void* zeros, int s_dtype, void* y,
                                 int y_dtype, void* part, int T, int Ci,
                                 int Co, int G, int tile, int splits,
                                 void* stream) {
  return w4tc::launch_a8(xq, xs, packed, scales, zeros, s_dtype, nullptr, y,
                         y_dtype, static_cast<float*>(part), 1, T, Ci, Co, G,
                         tile, splits, stream);
}
