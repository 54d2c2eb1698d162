// The W4A8 tile on the int8 tensor cores: the shared body of B5
// (w4a8_matmul.cu, one weight) and B7 (w4a8_grouped.cu, stacked experts).
//
// Function, as the reference's exact oracle ref.w4a8_matmul_ref:
//   Y[e, t, c] = xs[e, t] * sum_g scale[e, g, c] * part[e, t, g, c],
//   part = sum_{k in group g} xq[e, t, k] * clip(code[e, k, c]
//                                                - round(zero[e, g, c]),
//                                                -128, 127)
// for t < rows[e] (rows beyond come out zero), with int8 activation codes
// xq and their per-row scales xs (the wrapper quantizes with PyTorch ops,
// as the reference quantizes outside its kernel), the int4 codes in the
// reference's group-split packing, scales/zeros f32 or bf16, Y f32 or bf16.
//
// Exactness.  part is an exact int32 sum of int8 x int8 products.  Its cast
// to f32 is exact while |part| <= 127 * 128 * G < 2^24, that is G <= 1024.
// The fold is the oracle's order: acc += float(part) * scale per group
// (one fma), then y = acc * xs.  The zero point is folded into the codes
// per byte, exactly as the oracle clips: where some column of a warp's
// chunk has a zero outside [-112, 128] (the clip can engage), by two
// signed-saturating steps __vsubss4(__vsubss4(codes, z1), z2) with
// z1 = clamp(z), z2 = clamp(z - z1); elsewhere (no code can leave
// [-128, 127]) by one modular byte add (codes + (-z mod 256)), the same
// bytes in two instructions.  The choice is per warp and chunk, uniform
// across the warp.  The saturating fold alone, on every chunk, made the
// tile 13-37 % slower (measured on an H100, PERF.md).
//
// Instruction: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 with A and B
// swapped as in the W4A16 tile: the folded weight codes are the 16-row A
// operand (output columns as M, built in registers from the packed bytes),
// the int8 X tile is B (8 tokens as N).  The register-built A maps
// one-to-one onto its fragment; wgmma stays later work (ROADMAP queue B).
//
// k order.  In k-step s (32 k: 16 packed rows) lane (g8, t4) reads packed
// rows p..p+3, p = 16 s + 4 t4, of its 4 columns as four 32-bit words and
// transposes the 4x4 bytes with __byte_perm, so each column's word holds
// rows p..p+3.  Its low nibbles are MMA k 4 t4..+3 (weight rows p..p+3), its
// high nibbles MMA k 16 + 4 t4..+3 (weight rows G/2 + p..+3).  Column 2m of
// the thread's 4 is M row g8 of MMA tile m, column 2m + 1 M row g8 + 8.
// The B registers are the staged X rows at the same weight rows, two
// n-tiles' worth per ldmatrix.x4.  No repack: the kernel
// reads the reference's bytes.
//
// Tiling.  Two prefill tiles (B5/B7 run at >= 16 rows only): 64 rows x 128
// columns (4 x 2 warps) or x 256 columns (8 x 1 warps, where Co % 256 == 0).
// A warp owns 32 columns and kNT 8-row MMA tiles and reuses each A fragment
// for all of them; a chunk's (at most 4) k-steps are unrolled.  Chunks of at
// most 64 packed rows stream through the ring of w4_ring.cuh (3 stages,
// 16-byte cp.async where rows and offsets allow, else 4-byte): the packed
// [chunk, columns] tile, stored with a 16-byte-piece swizzle so the four t4
// lanes' rows fall in four banks, the group's scales and zeros rows and X's
// two [rows, chunk] slices (rows 16 bytes longer than their 32-byte
// multiple: conflict-free ldmatrix).  A chunk is padded to whole k-steps
// with zero X, so any G % 8 == 0 works; a group of G > 128 takes several
// stages and is folded once, at its last.  Split-K over groups when the
// output tiles give fewer than half a block per SM (a T <= 128 chunk of
// codellama's 4096-wide linears); the ring's sum kernel adds the partials
// in split order, then applies xs.  A block whose first row is at or past
// rows[e] reads nothing and writes zeros (with split-K, the sum writes
// them).
//
// Measured on an H100 (PERF.md): the tile runs at about 9x the
// int8 bound at T = 512.  With the shared-memory reads and the copies
// taken out of the k-loop, its MMAs alone take about 3/4 of its time:
// mma.sync m16n8k32 at one 8-warp block per SM (over 220 registers) issues
// about 0.17 MMA per clock per SM, some 16 % of the int8 peak, so the
// ring's depth (3, 4 or 6 stages) and the fold barely move it; wgmma is
// the way on.
#pragma once

#include "w4_ring.cuh"

namespace w4tc {
namespace {

constexpr int kA8Stages = 3;            // ring stages (one chunk each)

// Bytes of one A8 ring stage: packed [padded][bm] (swizzled), scales and
// zeros [bm] each, X [bn][2 * padded + 16] int8.
__host__ __device__ inline size_t a8_stage_bytes(int padded, int bm, int bn,
                                                 int ssize) {
  return (size_t)padded * bm + 2 * (size_t)bm * ssize +
         (size_t)bn * (2 * padded + 16);
}

__device__ __forceinline__ uint32_t splat(int v) {
  return (uint32_t)(uint8_t)(int8_t)v * 0x01010101u;
}

// Four codes in [0, 15] (one per byte) folded to their int8 values
// clip(code - z, -128, 127).  kFast: (u, v) = (c & 0x7f7f7f7f,
// c & 0x80808080), c = -z mod 256 per byte, valid for z in [-112, 128];
// else (u, v) = (z1, z2), the two clamped steps of the saturating fold.
template <bool kFast>
__device__ __forceinline__ uint32_t fold(uint32_t codes, uint32_t u,
                                         uint32_t v) {
  if (kFast) return (codes + u) ^ v;   // bytewise add, no carry out
  return __vsubss4(__vsubss4(codes, u), v);
}

// Four 8x16-byte matrices of shared memory, one row address per lane
// (lanes 8 i..8 i + 7 give matrix i's rows): lane (g8, t4) receives bytes
// 4 t4..4 t4 + 3 of row g8 of each, an m16n8k32 B register apiece.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const unsigned char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The k-steps of one chunk: `ws` is the thread's first packed row (4 t4)
// at its swizzled columns, `xb` the staged X row this lane addresses for
// ldmatrix (the warp's n-tile pair's low- and high-nibble slices).
template <bool kFast, int kBM, int kNT>
__device__ __forceinline__ void a8_steps(const unsigned char* ws,
                                         const unsigned char* xb,
                                         int x_stride, int steps,
                                         const uint32_t (&u)[4],
                                         const uint32_t (&v)[4],
                                         int (&part)[2][kNT][4]) {
  // at most kMaxChunk / 16 = 4 k-steps a chunk, unrolled: a step's
  // shared-memory reads issue under the previous step's MMAs
#pragma unroll
  for (int s = 0; s < kMaxChunk / 16; ++s) {
    if (s >= steps) break;
    const unsigned char* wr = ws + 16 * s * kBM;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + kBM);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wr + 2 * kBM);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wr + 3 * kBM);
    // 4x4 byte transpose: col[j] = byte j of w0..w3 (rows p..p+3)
    const uint32_t t01a = __byte_perm(w0, w1, 0x5140);
    const uint32_t t01b = __byte_perm(w0, w1, 0x7362);
    const uint32_t t23a = __byte_perm(w2, w3, 0x5140);
    const uint32_t t23b = __byte_perm(w2, w3, 0x7362);
    const uint32_t col[4] = {__byte_perm(t01a, t23a, 0x5410),
                             __byte_perm(t01a, t23a, 0x7632),
                             __byte_perm(t01b, t23b, 0x5410),
                             __byte_perm(t01b, t23b, 0x7632)};
    // A fragments of the two 16-column MMA tiles: registers 0/1 hold M
    // rows g8 / g8 + 8 (columns 2m / 2m + 1) at k 4 t4.. (low nibbles),
    // registers 2/3 the same rows at k 16 + 4 t4.. (high nibbles)
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * m + h;
        a[m][h] = fold<kFast>(col[j] & 0x0F0F0F0Fu, u[j], v[j]);
        a[m][2 + h] = fold<kFast>((col[j] >> 4) & 0x0F0F0F0Fu, u[j], v[j]);
      }
    // B registers of n-tiles 2q and 2q + 1: {b0, b1} each
#pragma unroll
    for (int q = 0; q < kNT / 2; ++q) {
      uint32_t b[4];
      ldsm_x4(b, xb + q * 16 * x_stride + 16 * s);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_s8(part[m][2 * q], a[m], b[0], b[1]);
        mma_s8(part[m][2 * q + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// One block: columns [blockIdx.x * kBM, +kBM), rows [row tile * kBN, +kBN)
// of expert blockIdx.z, groups of split blockIdx.y % splits.  Its warps: kWM
// along the columns (32 each) and kWN along the rows (kNT MMA tiles of 8
// each).  vec: copy_vec()'s bits.  kWhole: every ring stage holds one
// whole, unpadded group (G % 32 == 0, G <= 128, 16-byte X copies), so stage
// i is group g_begin + i and its X one run of G bytes; otherwise the stages
// walk the groups' chunks by a cursor and the int32 sums carry over from a
// group's chunk to the next.  The whole-group walk makes B5 at T = 512 some
// 5-8 % faster (measured on an H100, PERF.md).
template <typename ST, typename YT, int kWM, int kWN, int kNT, bool kWhole>
__global__ void __launch_bounds__(32 * kWM * kWN)
a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
          const uint8_t* __restrict__ packed, const ST* __restrict__ scales,
          const ST* __restrict__ zeros, const int* __restrict__ rows,
          YT* __restrict__ y, float* __restrict__ part, int E, int T, int Ci,
          int Co, int G, int splits, int vec) {
  constexpr int kThreads = 32 * kWM * kWN;
  constexpr int kBM = 32 * kWM;
  constexpr int kBN = 8 * kNT * kWN;
  static_assert(kBM % 128 == 0, "the swizzle permutes a row's 128 bytes");
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
    const Chunking ch(G, 16);
    const int half = ch.half, pad = ch.padded;
    const int x_stride = 2 * pad + 16;      // bytes
    const int s_bytes = kBM * (int)sizeof(ST);
    const int w_bytes = pad * kBM;
    const size_t st_bytes = a8_stage_bytes(pad, kBM, kBN, sizeof(ST));
    const int valid_cols = min(kBM, Co - col0);
    const size_t sz = (size_t)n_groups * Co;
    const uint8_t* pk = packed + (size_t)e * half * n_groups * Co + col0;
    const ST* sc_g = scales + (size_t)e * sz + col0;
    const ST* zr_g = zeros + (size_t)e * sz + col0;
    const int8_t* xg = xq + ((size_t)e * T + row0) * Ci;

    const bool w16 = vec & 1, s16 = vec & 2, x16 = vec & 4;
    const CopyLane w_lane(kBM, w16 ? 16 : 4, kThreads);
    const CopyLane s_lane(s_bytes, s16 ? 16 : 4, kThreads);
    const CopyLane x_lane(kWhole ? G : x_copy_bytes(ch, 1),
                          kWhole || x16 ? 16 : 4, kThreads);
    ChunkCursor next{g_begin, 0};    // the chunk the next load stages
    auto load = [&](int i) {         // stage i of the block's walk
      unsigned char* st = smem + (size_t)(i % kA8Stages) * st_bytes;
      int g = g_begin + i, c = 0;
      if (!kWhole) {
        g = next.g;
        c = next.c;
        next.next(ch.per_group);
      }
      const int s_valid = valid_cols * (int)sizeof(ST);
      copy_rows(st, kBM,
                pk + ((size_t)g * half + (size_t)c * kMaxChunk) * Co, Co,
                kWhole ? half : pad, kWhole ? half : ch.valid(c), valid_cols,
                w16, w_lane, true);
      copy_rows(st + w_bytes, 0,
                reinterpret_cast<const unsigned char*>(sc_g + (size_t)g * Co),
                0, 1, 1, s_valid, s16, s_lane);
      copy_rows(st + w_bytes + s_bytes, 0,
                reinterpret_cast<const unsigned char*>(zr_g + (size_t)g * Co),
                0, 1, 1, s_valid, s16, s_lane);
      if (kWhole)
        copy_rows(st + w_bytes + 2 * s_bytes, x_stride,
                  reinterpret_cast<const unsigned char*>(xg + (size_t)g * G),
                  (size_t)Ci, kBN, live - row0, G, true, x_lane);
      else
        copy_x_chunk(st + w_bytes + 2 * s_bytes, x_stride,
                     reinterpret_cast<const unsigned char*>(xg), (size_t)Ci,
                     kBN, live - row0, ch, g, c, 1, x16, x_lane);
    };

    int p[2][kNT][4];   // the group's exact int32 sums, over its chunks
    const int n_st = n * ch.per_group;
    ChunkCursor cur{g_begin, 0};     // the chunk this iteration computes
    for (int i = 0; i < kA8Stages - 1; ++i) {
      if (i < n_st) load(i);
      cp_commit();
    }
    for (int i = 0; i < n_st; ++i) {
      cp_wait_ring<kA8Stages>();  // chunk i has landed (this thread's copies)
      __syncthreads();       // everyone's copies; slot of i-1 is free
      if (i + kA8Stages - 1 < n_st) load(i + kA8Stages - 1);
      cp_commit();

      const unsigned char* st = smem + (size_t)(i % kA8Stages) * st_bytes;
      const int c = kWhole ? 0 : cur.c;
      if (!kWhole) cur.next(ch.per_group);
      if (kWhole || c == 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) p[m][nt][r] = 0;
      }

      // the zero points of the thread's 4 columns, as fold() takes them
      const ST* zs = reinterpret_cast<const ST*>(st + w_bytes + s_bytes) + cw;
      float z[4];
      bool safe = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        z[j] = rintf(to_f32(zs[j]));
        safe = safe && z[j] >= -112.f && z[j] <= 128.f;
      }
      const bool fast = __all_sync(0xffffffffu, safe);
      uint32_t u[4], v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (fast) {
          const uint32_t cz = splat(-(int)z[j]);
          u[j] = cz & 0x7F7F7F7Fu;
          v[j] = cz & 0x80808080u;
        } else {
          const float a = fminf(fmaxf(z[j], -128.f), 127.f);
          u[j] = splat((int)a);
          v[j] = splat((int)fminf(fmaxf(z[j] - a, -128.f), 127.f));
        }
      }
      const unsigned char* ws = st + 4 * t4 * kBM + swizzle(4 * t4, cw);
      // ldmatrix rows: lane l addresses row l % 8 of n-tile l / 16 (of
      // the pair), in the low (l / 8 even) or high-nibble slice
      const unsigned char* xb =
          st + w_bytes + 2 * s_bytes +
          (tw + (lane >> 4) * 8 + (lane & 7)) * x_stride +
          ((lane >> 3) & 1) * pad;
      const int steps = (ch.valid(c) + 15) / 16;
      if (fast)
        a8_steps<true, kBM, kNT>(ws, xb, x_stride, steps, u, v, p);
      else
        a8_steps<false, kBM, kNT>(ws, xb, x_stride, steps, u, v, p);
      if (!kWhole && c + 1 < ch.per_group) continue;

      // the group's last chunk: its exact sums leave integer space here,
      // acc += float(part) * scale
      const ST* ss = reinterpret_cast<const ST*>(st + w_bytes) + cw;
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = to_f32(ss[j]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[m][nt][r] =
                fmaf((float)p[m][nt][r], sc[2 * m + r / 2], acc[m][nt][r]);
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
      if (splits > 1) {        // the reduction applies xs, writes past `live`
        if (t < live) store4(part + (size_t)split * E * T * Co + o, v);
      } else {
        const float r = t < live ? xs[(size_t)e * T + t] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = t < live ? v[j] * r : 0.f;
        store4(y + o, v);
      }
    }
}

template <typename ST, typename YT, int kWM, int kWN, int kNT>
cudaError_t launch_a8_tile(const int8_t* xq, const float* xs,
                           const uint8_t* packed, const void* scales,
                           const void* zeros, const int* rows, void* y,
                           float* part, int E, int T, int Ci, int Co, int G,
                           int splits, cudaStream_t stream) {
  constexpr int kThreads = 32 * kWM * kWN;
  constexpr int kBM = 32 * kWM;
  constexpr int kBN = 8 * kNT * kWN;
  const Chunking ch(G, 16);
  const size_t smem =
      kA8Stages * a8_stage_bytes(ch.padded, kBM, kBN, sizeof(ST));
  if (smem > kMaxSmem || splits < 1 || splits > Ci / G)
    return cudaErrorInvalidValue;
  const int vec = copy_vec(packed, scales, zeros, xq, Co, sizeof(ST),
                           ch.half, 1);
  const bool whole = ch.per_group == 1 && ch.padded == ch.half && (vec & 4);
  auto kernel = whole ? a8_kernel<ST, YT, kWM, kWN, kNT, true>
                      : a8_kernel<ST, YT, kWM, kWN, kNT, false>;
  const cudaError_t opt_in = reserve_smem(kernel, smem);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((Co + kBM - 1) / kBM, ((T + kBN - 1) / kBN) * splits, E);
  kernel<<<grid, kThreads, smem, stream>>>(
      xq, xs, packed, static_cast<const ST*>(scales),
      static_cast<const ST*>(zeros), rows, static_cast<YT*>(y), part, E, T,
      Ci, Co, G, splits, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_splits<YT>(part, rows, xs, y, E, T, Co, splits, stream);
}

// The tiles (the wrapper's plan, kernels/w4a16_matmul.py:_plan, picks one;
// the numbers are the W4A16 tile's): 1 = 64 rows x 128 columns, 2 = 64 rows
// x 256 columns.
template <typename ST, typename YT>
cudaError_t launch_a8_tiled(const int8_t* xq, const float* xs,
                            const uint8_t* packed, const void* scales,
                            const void* zeros, const int* rows, void* y,
                            float* part, int E, int T, int Ci, int Co, int G,
                            int tile, int splits, cudaStream_t stream) {
  if (tile == 1)
    return launch_a8_tile<ST, YT, 4, 2, 4>(xq, xs, packed, scales, zeros,
                                           rows, y, part, E, T, Ci, Co, G,
                                           splits, stream);
  if (tile == 2)
    return launch_a8_tile<ST, YT, 8, 1, 8>(xq, xs, packed, scales, zeros,
                                           rows, y, part, E, T, Ci, Co, G,
                                           splits, stream);
  return cudaErrorInvalidValue;
}

inline int launch_a8(const void* xq, const void* xs, const void* packed,
                     const void* scales, const void* zeros, int s_dtype,
                     const int* rows, void* y, int y_dtype, float* part,
                     int E, int T, int Ci, int Co, int G, int tile,
                     int splits, void* stream) {
  const int8_t* x = static_cast<const int8_t*>(xq);
  const float* r = static_cast<const float*>(xs);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 8 || G % 8 || Ci % G || Co % 4) return (int)cudaErrorInvalidValue;
  if (s_dtype == kF32 && y_dtype == kF32)
    return launch_a8_tiled<float, float>(x, r, p, scales, zeros, rows, y,
                                         part, E, T, Ci, Co, G, tile, splits,
                                         s);
  if (s_dtype == kF32 && y_dtype == kBF16)
    return launch_a8_tiled<float, __nv_bfloat16>(x, r, p, scales, zeros,
                                                 rows, y, part, E, T, Ci, Co,
                                                 G, tile, splits, s);
  if (s_dtype == kBF16 && y_dtype == kF32)
    return launch_a8_tiled<__nv_bfloat16, float>(x, r, p, scales, zeros,
                                                 rows, y, part, E, T, Ci, Co,
                                                 G, tile, splits, s);
  if (s_dtype == kBF16 && y_dtype == kBF16)
    return launch_a8_tiled<__nv_bfloat16, __nv_bfloat16>(
        x, r, p, scales, zeros, rows, y, part, E, T, Ci, Co, G, tile, splits,
        s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace w4tc
