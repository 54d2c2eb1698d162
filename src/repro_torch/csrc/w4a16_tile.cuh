// The W4A16 tile on the tensor cores: the shared body of K1
// (w4a16_matmul.cu, one weight) and B6 (w4a16_grouped.cu, stacked experts).
//
// Function: Y[e, t, c] = sum_k X[e, t, k] * (code[e, k, c] - zero[e, g, c])
// * scale[e, g, c], g = k / G, for t < rows[e] (rows beyond come out zero),
// with the int4 codes in the reference's group-split packing: packed row r of
// group g holds row g*G + r in its low nibble and row g*G + G/2 + r in its
// high nibble.  X is f32 or bf16, scales/zeros f32 or bf16, the sum f32,
// stored in X's type.
//
// Arithmetic.  The tensor cores take the raw codes (0..15, exact in bf16):
// the tile never forms (code - zero) * scale in 16 bits, which would round
// the scale and, for an offset-only group, the zero.  Per quantization
// group it accumulates P[t, c] = sum_k x[t, k] * code[k, c] in f32 MMA
// accumulators and the group sum xs[t] = sum_k x[t, k] in f32, then folds
// acc[t, c] += scale[g, c] * (P[t, c] - zero[g, c] * xs[t]) at the group's
// end.  bf16 X is one MMA pass; f32 X is split into three bf16 terms
// hi + mid + lo that hold its 24-bit significand exactly, so each term x
// code product is exact and f32 X costs three passes through the same body.
//
// Instruction: mma.sync.m16n8k16 (bf16 -> f32) with A and B swapped: the
// weight codes are the 16-row A operand (output columns as M, built in
// registers from the packed bytes), the X tile is B (tokens as N, 8 per
// MMA), so a decode batch of <= 8 tokens wastes no M rows.  Hopper's wgmma
// would take A from registers too; it stays later work (ROADMAP queue B).
//
// k order.  Within a group the contraction order is free.  In k-step s
// (16 k) lane (g8, t4) takes packed rows r = 8s + t4 and r + 4 as two 32-bit
// words (4 columns each); __byte_perm pairs the two rows' bytes of one
// column, so one mask gives the A register {lo(r), lo(r+4)} (MMA k 2t4,
// 2t4+1; weight rows r, r+4) and a shift and mask {hi(r), hi(r+4)} (MMA k
// 2t4+8, 2t4+9; weight rows r+G/2, r+4+G/2).  The B registers read X at the
// same weight rows.  No repack: the kernel reads the reference's bytes.
//
// Tiling.  A block owns 32 output columns per column warp and 8 rows per
// MMA tile of its row warps, of one expert, and a range of quantization
// groups; three tiles (launch_tiled): 8 rows x 128 columns at decode, 64
// rows x 128 or x 256 columns at prefill (the wider stages X once for twice
// the columns).  The groups stream through the ring of w4_ring.cuh (3
// shared-memory stages, 16-byte cp.async, 4-byte copies where Co, the
// scales' rows or G/2 of X are not 16-byte multiples), one chunk of at most
// 64 packed rows per stage: the packed [chunk, columns] tile, the group's
// scales and zeros rows and X's two [rows, chunk] slices (the chunk's
// low-nibble rows r0.. and high-nibble rows G/2 + r0..).  A group of G > 128
// takes several stages and is folded once, at its last; G % 16 != 0 pads
// the chunk to whole k-steps with zero X.  Once a chunk has landed, the
// block turns its X slices into the MMA's B operand (the bf16 terms in MMA
// k order) and adds their sums to the group sums xs, once for all warps, in
// shared memory beside the ring.  When the output tiles alone give the card
// fewer than two blocks per SM, the wrapper splits the groups over `splits`
// blocks (split-K); each writes an f32 partial and the ring's second kernel
// sums them in split order (no float atomics: bitwise reproducible).  A
// block whose first row is at or past rows[e] reads nothing and writes
// zeros (with split-K, the sum writes them).
//
// Measured on an H100 (PERF.md): the decode tile is latency-bound (a ring
// of 3 stages, with more blocks per SM, beats 4 or 6 stages); at prefill
// the 256-column tile reaches about a twelfth (f32 X, three MMA passes) and
// a sixth (bf16 X) of the bf16 tensor-core peak on 2*T*Ci*Co operations,
// the B-operand pass and the fold idling the tensor cores once per group.
#pragma once

#include "w4_ring.cuh"

namespace w4tc {
namespace {

constexpr int kStages = 3;              // ring stages (one chunk each)
constexpr int kWPad = 32;               // bytes padding a staged packed row

// Bytes of one ring stage: packed [padded][bm + kWPad], scales and zeros
// [bm] each, X [bn][2 * padded + 16 / xsize] (the chunk's low-nibble rows,
// then its high-nibble rows).
__host__ __device__ inline size_t a16_stage_bytes(int padded, int bm, int bn,
                                                  int xsize, int ssize) {
  return (size_t)padded * (bm + kWPad) + 2 * (size_t)bm * ssize +
         (size_t)bn * (2 * padded + 16 / xsize) * xsize;
}

// Bytes after the ring: the current chunk's B operand, [terms][bn]
// [2 * padded + 8] bf16 in MMA k order, and its group sums xs [bn] f32.
__host__ __device__ inline size_t operand_bytes(int padded, int bn,
                                                int terms) {
  return (size_t)terms * bn * (2 * padded + 8) * 2 + (size_t)bn * 4;
}

// Two codes of one packed column from the byte pair u (byte 0: row r,
// byte 2: row r + 4) as a bf16x2 {code(r), code(r+4)}: 0x4300 | c is the
// bf16 128 + c, and subtracting 128 leaves c exactly.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t nibbles) {
  const uint32_t v = nibbles | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Eight consecutive X values from shared memory (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// x = hi + mid + lo, three bf16 terms (kTerms == 3; exact for f32 x), or
// the one bf16 value (kTerms == 1; bf16 x), as bf16x2 registers of (a, b).
template <int kTerms>
__device__ __forceinline__ void split_terms(float a, float b,
                                            uint32_t (&out)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    out[i] = *reinterpret_cast<uint32_t*>(&h);
    if (i + 1 < kTerms) {
      const float2 f = __bfloat1622float2(h);
      a -= f.x;
      b -= f.y;
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: columns [blockIdx.x * kBM, +kBM), rows [row tile * kBN, +kBN)
// of expert blockIdx.z, groups of split blockIdx.y % splits.  Its warps: kWM
// along the columns (32 each) and kWN along the rows (kNT MMA tiles of 8
// each).  vec: copy_vec()'s bits.  kWhole: every ring stage holds one
// whole, unpadded group (G % 16 == 0, G <= 128, 16-byte X copies), so
// stage i is group g_begin + i, its X is one run of G values and P and xs
// start afresh at every stage; otherwise (G > 128, or a padded chunk) the
// stages walk the groups' chunks by a cursor and P and xs carry over from
// a group's chunk to the next.  The general walk cost the bf16 tile 4-7 %
// at prefill against the one-group-a-stage ring it replaced (measured on an
// H100, PERF.md), hence the two.
template <typename XT, typename ST, int kWM, int kWN, int kNT, bool kWhole>
__global__ void __launch_bounds__(32 * kWM * kWN)
a16_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ packed,
           const ST* __restrict__ scales, const ST* __restrict__ zeros,
           const int* __restrict__ rows, XT* __restrict__ y,
           float* __restrict__ part, int E, int T, int Ci, int Co, int G,
           int splits, int vec) {
  constexpr int kThreads = 32 * kWM * kWN;
  constexpr int kBM = 32 * kWM;
  constexpr int kBN = 8 * kNT * kWN;
  constexpr int kTerms = sizeof(XT) == 4 ? 3 : 1;
  constexpr int kTPR = kThreads / kBN;      // threads per X row (staging)
  static_assert(kTPR * kBN == kThreads && kTPR <= 32 && !(kTPR & (kTPR - 1)),
                "an X row's threads are a power-of-two part of one warp");
  extern __shared__ __align__(16) unsigned char smem[];

  const int e = blockIdx.z;
  const int split = blockIdx.y % splits;
  const int row0 = (blockIdx.y / splits) * kBN;
  const int col0 = blockIdx.x * kBM;
  const int n_groups = Ci / G;
  const int g_begin = (int)((long long)split * n_groups / splits);
  const int n = (int)((long long)(split + 1) * n_groups / splits) - g_begin;
  const int live = rows ? min(max(rows[e], 0), T) : T;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % kWM, wn = warp / kWM;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int cw = wm * 32 + 4 * g8;          // this thread's 4 columns
  const int tw = wn * kNT * 8;              // this warp's first row

  float acc[2][kNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][nt][r] = 0.f;

  if (row0 < live) {
    const Chunking ch(G, 8);
    const int half = ch.half, pad = ch.padded;
    const int w_stride = kBM + kWPad;
    const int x_stride = 2 * pad + 16 / (int)sizeof(XT);
    const int s_bytes = kBM * (int)sizeof(ST);
    const int w_bytes = pad * w_stride;
    const size_t st_bytes =
        a16_stage_bytes(pad, kBM, kBN, sizeof(XT), sizeof(ST));
    const int b_stride = pad + 4;           // 32-bit words per B row
    uint32_t* bop = reinterpret_cast<uint32_t*>(smem + kStages * st_bytes);
    float* xsum_s = reinterpret_cast<float*>(bop + kTerms * kBN * b_stride);
    const int valid_cols = min(kBM, Co - col0);
    const size_t sz = (size_t)n_groups * Co;
    const uint8_t* pk = packed + (size_t)e * half * n_groups * Co + col0;
    const ST* sc_g = scales + (size_t)e * sz + col0;
    const ST* zr_g = zeros + (size_t)e * sz + col0;
    const XT* xg = x + ((size_t)e * T + row0) * Ci;

    const bool w16 = vec & 1, s16 = vec & 2, x16 = vec & 4;
    const CopyLane w_lane(kBM, w16 ? 16 : 4, kThreads);
    const CopyLane s_lane(s_bytes, s16 ? 16 : 4, kThreads);
    const CopyLane x_lane(kWhole ? G * (int)sizeof(XT)
                                 : x_copy_bytes(ch, sizeof(XT)),
                          kWhole || x16 ? 16 : 4, kThreads);
    ChunkCursor next{g_begin, 0};    // the chunk the next load stages
    auto load = [&](int i) {         // stage i of the block's walk
      unsigned char* st = smem + (size_t)(i % kStages) * st_bytes;
      int g = g_begin + i, c = 0;
      if (!kWhole) {
        g = next.g;
        c = next.c;
        next.next(ch.per_group);
      }
      const int s_valid = valid_cols * (int)sizeof(ST);
      copy_rows(st, w_stride,
                pk + ((size_t)g * half + (size_t)c * kMaxChunk) * Co, Co,
                kWhole ? half : pad, kWhole ? half : ch.valid(c), valid_cols,
                w16, w_lane);
      copy_rows(st + w_bytes, 0,
                reinterpret_cast<const unsigned char*>(sc_g + (size_t)g * Co),
                0, 1, 1, s_valid, s16, s_lane);
      copy_rows(st + w_bytes + s_bytes, 0,
                reinterpret_cast<const unsigned char*>(zr_g + (size_t)g * Co),
                0, 1, 1, s_valid, s16, s_lane);
      if (kWhole)
        copy_rows(st + w_bytes + 2 * s_bytes, x_stride * (int)sizeof(XT),
                  reinterpret_cast<const unsigned char*>(xg + (size_t)g * G),
                  (size_t)Ci * sizeof(XT), kBN, live - row0,
                  G * (int)sizeof(XT), true, x_lane);
      else
        copy_x_chunk(st + w_bytes + 2 * s_bytes, x_stride * (int)sizeof(XT),
                     reinterpret_cast<const unsigned char*>(xg),
                     (size_t)Ci * sizeof(XT), kBN, live - row0, ch, g, c,
                     sizeof(XT), x16, x_lane);
    };

    float P[2][kNT][4];   // the group's raw-code sums, over its chunks
    const int n_st = n * ch.per_group;
    ChunkCursor cur{g_begin, 0};     // the chunk this iteration computes
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_st) load(i);
      cp_commit();
    }
    for (int i = 0; i < n_st; ++i) {
      cp_wait_ring<kStages>();  // chunk i has landed (this thread's copies)
      __syncthreads();       // everyone's copies; slot of i-1 is free
      if (i + kStages - 1 < n_st) load(i + kStages - 1);
      cp_commit();

      const unsigned char* st = smem + (size_t)(i % kStages) * st_bytes;
      const int c = kWhole ? 0 : cur.c;
      if (!kWhole) cur.next(ch.per_group);
      const int steps = (ch.valid(c) + 7) / 8;
      {
        // the chunk's X slice into the B operand, once for all warps.  Per
        // k-step s (16 MMA k) a row holds 8 words: lane t4's register b0
        // {x[8s+t4], x[8s+t4+4]} at word 2 t4 and b1 {x[h+8s+t4],
        // x[h+8s+t4+4]} at word 2 t4 + 1 (h = G/2), one 64-bit load apart.
        // A thread converts whole k-steps: 16 x values, 8 words per term.
        // The group sums xs add up over the group's chunks.
        const XT* xrow = reinterpret_cast<const XT*>(st + w_bytes +
                                                     2 * s_bytes) +
                         (size_t)(threadIdx.x / kTPR) * x_stride;
        uint32_t* brow = bop + (threadIdx.x / kTPR) * b_stride;
        float sum = 0.f;
        for (int ks = threadIdx.x % kTPR; ks < steps; ks += kTPR) {
          float lo[8], hi[8];
          load8(xrow + 8 * ks, lo);
          load8(xrow + pad + 8 * ks, hi);
          uint32_t w[kTerms][8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum += (lo[i] + lo[i + 4]) + (hi[i] + hi[i + 4]);
            uint32_t t0[kTerms], t1[kTerms];
            split_terms<kTerms>(lo[i], lo[i + 4], t0);
            split_terms<kTerms>(hi[i], hi[i + 4], t1);
#pragma unroll
            for (int k = 0; k < kTerms; ++k) {
              w[k][2 * i] = t0[k];
              w[k][2 * i + 1] = t1[k];
            }
          }
#pragma unroll
          for (int k = 0; k < kTerms; ++k) {
            uint4* o = reinterpret_cast<uint4*>(brow + k * kBN * b_stride +
                                                8 * ks);
            o[0] = make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
            o[1] = make_uint4(w[k][4], w[k][5], w[k][6], w[k][7]);
          }
        }
#pragma unroll
        for (int o = kTPR / 2; o > 0; o /= 2)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (threadIdx.x % kTPR == 0) {
          float* xr = xsum_s + threadIdx.x / kTPR;
          *xr = !kWhole && c ? *xr + sum : sum;
        }
      }
      __syncthreads();   // the B operand and xs are complete

      const unsigned char* ws = st + cw;
      const uint32_t* bw = bop + (tw + g8) * b_stride + 2 * t4;

      if (kWhole || c == 0) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int r = 0; r < 4; ++r) P[m][nt][r] = 0.f;
      }

#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        const int r = 8 * s + t4;
        const uint32_t w0 =
            *reinterpret_cast<const uint32_t*>(ws + r * w_stride);
        const uint32_t w1 =
            *reinterpret_cast<const uint32_t*>(ws + (r + 4) * w_stride);
        // A fragments of the two 16-column MMA tiles: M row g8 is column
        // byte 2m, M row g8 + 8 column byte 2m + 1
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * m + h;
            const uint32_t u = __byte_perm(w0, w1, j | ((4 + j) << 8));
            a[m][h] = codes_bf16x2(u & 0x000F000Fu);
            a[m][2 + h] = codes_bf16x2((u >> 4) & 0x000F000Fu);
          }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int k = 0; k < kTerms; ++k) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                bw + (k * kBN + nt * 8) * b_stride + 8 * s);
#pragma unroll
            for (int m = 0; m < 2; ++m) mma_bf16(P[m][nt], a[m], b.x, b.y);
          }
      }
      if (!kWhole && c + 1 < ch.per_group) continue;

      // the group's last chunk: fold it in, acc += scale * (P - zero * xs)
      const ST* ss = reinterpret_cast<const ST*>(st + w_bytes) + cw;
      const ST* zs = reinterpret_cast<const ST*>(st + w_bytes + s_bytes) + cw;
      float sc[4], zr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = to_f32(ss[j]);
        zr[j] = to_f32(zs[j]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float xa = xsum_s[tw + nt * 8 + 2 * t4];
        const float xb = xsum_s[tw + nt * 8 + 2 * t4 + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int j0 = 2 * m, j1 = 2 * m + 1;
          acc[m][nt][0] = fmaf(sc[j0], fmaf(-zr[j0], xa, P[m][nt][0]),
                               acc[m][nt][0]);
          acc[m][nt][1] = fmaf(sc[j0], fmaf(-zr[j0], xb, P[m][nt][1]),
                               acc[m][nt][1]);
          acc[m][nt][2] = fmaf(sc[j1], fmaf(-zr[j1], xa, P[m][nt][2]),
                               acc[m][nt][2]);
          acc[m][nt][3] = fmaf(sc[j1], fmaf(-zr[j1], xb, P[m][nt][3]),
                               acc[m][nt][3]);
        }
      }
    }
  }

  // C fragment: c[h] is (column byte 2m, row 2 t4 + h), c[2 + h] (column
  // byte 2m + 1, the same row); rows at or past `live` store zeros
  const int col = col0 + cw;
  if (col >= Co) return;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = row0 + tw + nt * 8 + 2 * t4 + h;
      if (t >= T) continue;
      float v[4] = {acc[0][nt][h], acc[0][nt][2 + h], acc[1][nt][h],
                    acc[1][nt][2 + h]};
      const size_t o = ((size_t)e * T + t) * Co + col;
      if (splits > 1) {        // the reduction writes the rows past `live`
        if (t < live) store4(part + (size_t)split * E * T * Co + o, v);
      } else {
        if (t >= live) v[0] = v[1] = v[2] = v[3] = 0.f;
        store4(y + o, v);
      }
    }
}

template <typename XT, typename ST, int kWM, int kWN, int kNT>
cudaError_t launch_tile(const void* x, const uint8_t* packed,
                        const void* scales, const void* zeros,
                        const int* rows, void* y, float* part, int E, int T,
                        int Ci, int Co, int G, int splits,
                        cudaStream_t stream) {
  constexpr int kThreads = 32 * kWM * kWN;
  constexpr int kBM = 32 * kWM;
  constexpr int kBN = 8 * kNT * kWN;
  const Chunking ch(G, 8);
  const size_t smem =
      kStages * a16_stage_bytes(ch.padded, kBM, kBN, sizeof(XT), sizeof(ST)) +
      operand_bytes(ch.padded, kBN, sizeof(XT) == 4 ? 3 : 1);
  if (smem > kMaxSmem || splits < 1 || splits > Ci / G)
    return cudaErrorInvalidValue;
  const int vec = copy_vec(packed, scales, zeros, x, Co, sizeof(ST), ch.half,
                           sizeof(XT));
  const bool whole = ch.per_group == 1 && ch.padded == ch.half && (vec & 4);
  auto kernel = whole ? a16_kernel<XT, ST, kWM, kWN, kNT, true>
                      : a16_kernel<XT, ST, kWM, kWN, kNT, false>;
  const cudaError_t opt_in = reserve_smem(kernel, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((Co + kBM - 1) / kBM, ((T + kBN - 1) / kBN) * splits, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), packed, static_cast<const ST*>(scales),
      static_cast<const ST*>(zeros), rows, static_cast<XT*>(y), part, E, T,
      Ci, Co, G, splits, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_splits<XT>(part, rows, nullptr, y, E, T, Co, splits, stream);
}

// The tiles (the wrapper's plan, kernels/w4a16_matmul.py:_plan, picks
// one): 0 = 8 rows x 128 columns (decode), 1 = 64 rows x 128 columns, 2 =
// 64 rows x 256 columns (prefill; the wider tile stages X once for twice
// the columns and builds each A fragment for twice the MMAs).
template <typename XT, typename ST>
cudaError_t launch_tiled(const void* x, const uint8_t* packed,
                         const void* scales, const void* zeros,
                         const int* rows, void* y, float* part, int E, int T,
                         int Ci, int Co, int G, int tile, int splits,
                         cudaStream_t stream) {
  if (tile == 0)
    return launch_tile<XT, ST, 4, 1, 1>(x, packed, scales, zeros, rows, y,
                                        part, E, T, Ci, Co, G, splits,
                                        stream);
  if (tile == 1)
    return launch_tile<XT, ST, 4, 2, 4>(x, packed, scales, zeros, rows, y,
                                        part, E, T, Ci, Co, G, splits,
                                        stream);
  if (tile == 2)
    return launch_tile<XT, ST, 8, 1, 8>(x, packed, scales, zeros, rows, y,
                                        part, E, T, Ci, Co, G, splits,
                                        stream);
  return cudaErrorInvalidValue;
}

inline int launch(const void* x, int x_dtype, const void* packed,
                  const void* scales, const void* zeros, int s_dtype,
                  const int* rows, void* y, float* part, int E, int T, int Ci,
                  int Co, int G, int tile, int splits, void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 8 || G % 8 || Ci % G || Co % 4) return (int)cudaErrorInvalidValue;
  if (x_dtype == kF32 && s_dtype == kF32)
    return launch_tiled<float, float>(x, p, scales, zeros, rows, y, part, E,
                                      T, Ci, Co, G, tile, splits, s);
  if (x_dtype == kF32 && s_dtype == kBF16)
    return launch_tiled<float, __nv_bfloat16>(x, p, scales, zeros, rows, y,
                                              part, E, T, Ci, Co, G, tile,
                                              splits, s);
  if (x_dtype == kBF16 && s_dtype == kF32)
    return launch_tiled<__nv_bfloat16, float>(x, p, scales, zeros, rows, y,
                                              part, E, T, Ci, Co, G, tile,
                                              splits, s);
  if (x_dtype == kBF16 && s_dtype == kBF16)
    return launch_tiled<__nv_bfloat16, __nv_bfloat16>(
        x, p, scales, zeros, rows, y, part, E, T, Ci, Co, G, tile, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace w4tc
