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

#include "common.cuh"

namespace {

constexpr int kColsPerThread = 4;
constexpr int kColLanes = 16;
constexpr int kBlockCo = kColLanes * kColsPerThread;  // 64 columns per block
constexpr int kSplits = 8;
constexpr int kTTile = 8;
constexpr int kThreads = kColLanes * kSplits;          // 128

size_t smem_bytes(int G) {
  return (size_t)kSplits * kTTile * G                          // int8 X codes
         + sizeof(float) * (size_t)kSplits * kTTile * kBlockCo;  // reduction
}

__device__ __forceinline__ uint32_t splat(int v) {
  return (uint32_t)(uint8_t)(int8_t)v * 0x01010101u;
}

// int8 zero-point fold of 4 codes in [0, 15]: clip(code - z, -128, 127),
// with z split into two int8 steps z1 + z2 (both clamped) so the signed
// saturation of each step reproduces the single clip exactly.
__device__ __forceinline__ uint32_t fold(uint32_t codes, uint32_t z1,
                                         uint32_t z2) {
  return __vsubss4(__vsubss4(codes, z1), z2);
}

template <typename ST, typename YT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
            const ST* __restrict__ zeros, YT* __restrict__ y, int T, int Ci,
            int Co, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kColLanes;
  const int ks = threadIdx.x / kColLanes;
  const int wpr = G / 4;  // 32-bit words per staged activation row
  int* xw = reinterpret_cast<int*>(smem_raw) + (size_t)ks * kTTile * wpr;
  float* red = reinterpret_cast<float*>(
      smem_raw + (size_t)kSplits * kTTile * G);  // [kSplits][kTTile][kBlockCo]

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
    __syncthreads();  // the previous round's reads of xw are finished
    if (g < n_groups) {
      for (int i = lane; i < kTTile * wpr; i += kColLanes) {
        const int tt = i / wpr, w = i - tt * wpr;
        const int t = t0 + tt;
        xw[i] = t < T ? __ldg(reinterpret_cast<const int*>(
                            xq + (size_t)t * Ci + (size_t)g * G) + w)
                      : 0;
      }
    }
    __syncthreads();
    if (g < n_groups && col_ok) {
      float sc[kColsPerThread];
      uint32_t z1[kColsPerThread], z2[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        sc[j] = to_f32(scales[(size_t)g * Co + col0 + j]);
        const float z = rintf(to_f32(zeros[(size_t)g * Co + col0 + j]));
        const float a = fminf(fmaxf(z, -128.f), 127.f);
        const float b = fminf(fmaxf(z - a, -128.f), 127.f);
        z1[j] = splat((int)a);
        z2[j] = splat((int)b);
      }
      int part[kTTile][kColsPerThread];
#pragma unroll
      for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) part[tt][j] = 0;
      const uint8_t* prow = packed + (size_t)g * half * Co + col0;
#pragma unroll 2
      for (int r = 0; r < half; r += 4) {
        const uint32_t w0 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)r * Co));
        const uint32_t w1 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)(r + 1) * Co));
        const uint32_t w2 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)(r + 2) * Co));
        const uint32_t w3 = __ldg(reinterpret_cast<const unsigned int*>(
            prow + (size_t)(r + 3) * Co));
        // 4x4 byte transpose: col[j] = byte j of w0..w3 (rows r..r+3)
        const uint32_t t01a = __byte_perm(w0, w1, 0x5140);
        const uint32_t t01b = __byte_perm(w0, w1, 0x7362);
        const uint32_t t23a = __byte_perm(w2, w3, 0x5140);
        const uint32_t t23b = __byte_perm(w2, w3, 0x7362);
        uint32_t col[kColsPerThread];
        col[0] = __byte_perm(t01a, t23a, 0x5410);
        col[1] = __byte_perm(t01a, t23a, 0x7632);
        col[2] = __byte_perm(t01b, t23b, 0x5410);
        col[3] = __byte_perm(t01b, t23b, 0x7632);
        int lo[kColsPerThread], hi[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          lo[j] = (int)fold(col[j] & 0x0F0F0F0Fu, z1[j], z2[j]);
          hi[j] = (int)fold((col[j] >> 4) & 0x0F0F0F0Fu, z1[j], z2[j]);
        }
#pragma unroll
        for (int tt = 0; tt < kTTile; ++tt) {
          const int xl = xw[tt * wpr + r / 4];
          const int xh = xw[tt * wpr + (half + r) / 4];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            part[tt][j] = __dp4a(xl, lo[j], part[tt][j]);
            part[tt][j] = __dp4a(xh, hi[j], part[tt][j]);
          }
        }
      }
      // the group's exact int32 sums leave integer space here, scaled by
      // the group's weight scale (|part| < 2^24, so the f32 cast is exact)
#pragma unroll
      for (int tt = 0; tt < kTTile; ++tt)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          acc[tt][j] += static_cast<float>(part[tt][j]) * sc[j];
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
      store_as(&y[(size_t)t * Co + col], s * xs[t]);
    }
  }
}

template <typename ST, typename YT>
cudaError_t launch(const int8_t* xq, const float* xs, const uint8_t* packed,
                   const void* scales, const void* zeros, void* y, int T,
                   int Ci, int Co, int G, cudaStream_t stream) {
  const size_t smem = smem_bytes(G);
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
