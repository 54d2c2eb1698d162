// B6: grouped (stacked-expert) W4A16 GEMM,
// Y[E, C, Co] = X[E, C, Ci] @ W[E, Ci, Co], one independent product per
// expert e.
//
// Replaces the Pallas TPU kernel repro/kernels/w4a16_grouped.py:_kernel
// (entry w4a16_grouped_matmul, pallas_call at w4a16_grouped.py:165), the
// MoE expert contraction of repro/models/mlp.py:_expert_matmul.
//
//   x       X  [E, C, Ci]       per-expert capacity rows (f32 or bf16); rows
//                               no token was dispatched to are zero
//   packed  u8 [E, Ci/2, Co]    int4 codes in the group-split layout of K1
//   scales  S  [E, Ci/G, Co]    S = f32 or bf16
//   zeros   S  [E, Ci/G, Co]    integer-valued zero points
//   y       X  [E, C, Co]       f32 sums, stored in X's type
//
// What bounds it on an H100: at decode (C = top_k = 8 rows per expert, the
// capacity floor) it is a batch of E small GEMVs and the packed weight
// bytes dominate: E * (Ci*Co/2 + 2 * Ci/G * Co * 4) — about 9.4 MB for
// E = 32, 1024 x 512, f32 scales — so it is bound by HBM bytes.  At prefill
// capacities (hundreds of rows) the f32 FMAs on the CUDA cores dominate.
//
// Design: K1's tile (w4::a16_tile in common.cuh: 64 columns x 8 rows per
// block, 8 k-splits taking whole quantization groups round-robin) with the
// expert as the outermost grid axis: blockIdx.y = e * row_tiles + row_tile,
// and every operand offset to expert e before the tile runs.  A zero
// capacity row yields an exact zero output row whatever the zero points (it
// multiplies every dequantized weight by 0).

#include "common.cuh"

namespace {

using w4::kBlockCo;
using w4::kThreads;
using w4::kTTile;

template <typename XT, typename ST>
__global__ void __launch_bounds__(kThreads)
w4a16_grouped_kernel(const XT* __restrict__ x,
                     const uint8_t* __restrict__ packed,
                     const ST* __restrict__ scales,
                     const ST* __restrict__ zeros, XT* __restrict__ y, int C,
                     int Ci, int Co, int G, int row_tiles) {
  extern __shared__ float smem[];
  const int e = blockIdx.y / row_tiles;
  const int tile = blockIdx.y - e * row_tiles;
  const size_t sz = (size_t)(Ci / G) * Co;
  w4::a16_tile<XT, ST>(x + (size_t)e * C * Ci, packed + (size_t)e * (Ci / 2) * Co,
                       scales + e * sz, zeros + e * sz, y + (size_t)e * C * Co,
                       C, Ci, Co, G, blockIdx.x, tile, smem);
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const uint8_t* packed, const void* scales,
                   const void* zeros, void* y, int E, int C, int Ci, int Co,
                   int G, cudaStream_t stream) {
  const size_t smem = w4::a16_smem_bytes(G);
  cudaError_t err = reserve_smem(w4a16_grouped_kernel<XT, ST>, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (C + kTTile - 1) / kTTile;
  dim3 grid((Co + kBlockCo - 1) / kBlockCo, E * row_tiles);
  w4a16_grouped_kernel<XT, ST><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), packed, static_cast<const ST*>(scales),
      static_cast<const ST*>(zeros), static_cast<XT*>(y), C, Ci, Co, G,
      row_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_w4a16_grouped(const void* x, int x_dtype,
                                   const void* packed, const void* scales,
                                   const void* zeros, int s_dtype, void* y,
                                   int E, int C, int Ci, int Co, int G,
                                   void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && s_dtype == kF32)
    return launch<float, float>(x, p, scales, zeros, y, E, C, Ci, Co, G, s);
  if (x_dtype == kF32 && s_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, p, scales, zeros, y, E, C, Ci, Co,
                                        G, s);
  if (x_dtype == kBF16 && s_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, p, scales, zeros, y, E, C, Ci, Co,
                                        G, s);
  if (x_dtype == kBF16 && s_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, p, scales, zeros, y, E, C,
                                                 Ci, Co, G, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
