// The tensor-core latent-attention tile shared by B8 (mla_paged_decode.cu)
// and B9 (mla_paged_prefill.cu).
//
// Absorbed MLA is MQA with H query heads on one latent "KV head": every
// query row (q_lat [r] ‖ q_pe [dr], f32) scores every latent key row
// (ckv [r] ‖ kpe [dr]) and sums ckv (the values) under its softmax.  So
// both kernels are dense GEMM-shaped problems: a block takes kRows = 64
// query rows (B8: 64 heads of one slot; B9: 64 flattened t*H + h rows) and
// streams key tiles of kKeys = 32 latent rows through shared memory; all
// 64 rows use each staged tile.
//
// Block: 8 warps in two warpgroups.  Warp w takes the 16 query rows
// 16 * (w % 4) and the value columns of half w / 4: a [64, 512] f32
// accumulator is 128 registers a thread over 256 threads (one warpgroup
// would need 256).  The two warps of a row group (w and w + 4) split each
// tile's keys instead, 16 each, for the score product (as DeepSeek's
// FlashMLA splits its tiles between two warpgroups): each scores its 16
// keys over all r + dr dimensions, the pair trades row maxima through
// shared memory (one named barrier of 64 threads), each exponentiates its
// own keys against the common maximum and publishes its P (a second
// barrier), and both then multiply the tile's full 32-key P into their
// own value columns.  Each warp sums l over its own keys; the pair adds
// the two halves at the end in a fixed order.
//
// Shared memory: the query tile, f32 rows [q_lat padded to rk ‖ q_pe
// padded to drk ‖ 4 floats of padding] (at r = 512, dr = 64: 148,480 B);
// a ring of key tiles, each key row [ckv padded to rv ‖ kpe padded to drk]
// in the pool's or the suffix's element type (int8 codes stay codes) plus
// 16 bytes of padding, with int8 pools the tile's ckv / kpe row scales
// after the rows; then the pairs' exchange (P [64, 32 + 2] and two floats
// a row, 9,216 B).  rk and drk are r and dr rounded up to 32 (whole score
// slices, below), rv is r rounded up to 128 (two halves of whole 64-column
// chunks); every pad is zero-filled by the copies, so any width runs the
// tile.  The ring has two stages where they fit in 227 KB, else one: f32
// key rows at full width (74,240 B a tile) take one; bf16 and int8 take
// two (bf16 to the last byte).  Widths whose one stage does not fit
// (r > 512, or f32 rows too wide) take the kernels' CUDA-core path (the
// mla:: helpers of common.cuh); make_geo() decides, by shape.  Tiles are
// filled by cp.async (16-byte pieces where rows allow, else 4; 2- or
// 1-byte synchronous copies for odd fp widths), key rows gathered one at
// a time through the block table, so a tile spans any number of pages;
// rows past the live bound are zero-filled, never read.
//
// Arithmetic: S = Q K^T and O += P V on mma.sync.  The tolerance against
// the reference (1e-5 of max |out|) rules out plain TF32, so:
//  - f32 x f32 (f32 pools, B9's f32 suffix) is 3xTF32 on m16n8k8 (each
//    operand = big + small cut by bit mask; small*big + big*small +
//    big*big);
//  - f32 x bf16 and f32 x int8 codes (exact in bf16) split the f32 side
//    (Q, or P) into three exact bf16 terms, cut by bit mask, on m16n8k16;
//    int8 codes become bf16 by integer and f32 adds, not conversions.
// A score is summed in 32-dimension slices (kChunk), each slice's three
// product terms in their own accumulators, added in f32.
// The int8 row scales multiply the score columns (s_lat * cs + s_pe * ps,
// the reference's order, so the two score parts keep their own
// accumulators) and the P columns (p * cs), never the softmax sum.  For
// 3xTF32 P V the MMA's k order over 8 keys is permuted (k tq <-> key 2 tq,
// tq + 4 <-> 2 tq + 1) so the score accumulators are the A operand as they
// stand.  P V, like the score, is summed in fresh accumulators: each
// tile's 32 keys in their own, added to o in f32, so no accumulator
// carries a long key range.  Key n-tiles past a tile's live keys (a
// split's or prefix's last tile, the causal diagonal) skip their MMAs:
// their P is exactly 0.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace mla_tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;             // query rows per block
constexpr int kKeys = 32;             // key rows per tile
constexpr int kNT = 32;               // value n-tiles a warp holds
constexpr int kMaxR = 2 * 8 * kNT;    // widest r the tile takes (512)
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory per block
// The tensor cores add each MMA's products to its accumulator truncated,
// not rounded, so a score summed over r + dr = 576 dimensions in one
// accumulator (216 3xTF32 MMAs) drifts by about 1e-5 of itself: each
// kChunk-dimension slice is summed in a fresh accumulator and added to the
// score in f32 (rounded).  Depths are padded to whole slices.
constexpr int kChunk = 32;
// value n-tiles whose P V a fresh accumulator takes at a time (values()):
// one 64-column chunk, so back-to-back MMAs feed 8 independent accumulators
// and P is read from the exchange once a chunk (4 n-tiles a block cost B9
// 5-8 % more; 255 registers, no spill)
constexpr int kFreshNB = 8;
// exchange P row stride, floats: 2 of padding halve the bank conflicts
// of its 8-byte stores and keep two bf16 stages within 227 KB
constexpr int kPld = kKeys + 2;
constexpr int kExBytes = (kRows * kPld + 2 * kRows) * 4;

// Tile geometry, computed on the host.
struct Geo {
  int r, dr;         // latent and rope widths
  int rk, drk;       // r, dr rounded up to kChunk: the score's depth
  int rv;            // r rounded up to 128: the staged value width
  int nch;           // 64-column value chunks per warp (rv / 128)
  int ldq;           // staged query row stride, floats
  int stage_bytes;   // one ring stage
  int stages;        // 1 or 2 (0: the tile does not fit)
  int ex_off;        // byte offset of the pairs' exchange
  int pq, pqe;       // copy pieces: q_lat, q_pe rows
  int pc, pp;        // pool ckv, kpe rows
  int psc, psp;      // B9's suffix ckv, kpe rows
  float scale;
};

// Staged key row stride, bytes, for elements of `es` bytes.
__host__ __device__ inline int key_ld(const Geo& G, int es) {
  return (G.rv + G.drk) * es + 16;
}
__host__ __device__ inline size_t q_bytes(const Geo& G) {
  return (size_t)kRows * G.ldq * 4;
}

// The geometry for widths r, dr, pool key elements of `ep` bytes (with
// int8 row scales where quant) and suffix key elements of `es` bytes (B9;
// B8 passes ep); stages == 0 where one stage does not fit.
inline Geo make_geo(int r, int dr, int ep, int es, bool quant, float scale) {
  Geo G{};
  G.r = r;
  G.dr = dr;
  G.rk = (r + kChunk - 1) / kChunk * kChunk;
  G.drk = (dr + kChunk - 1) / kChunk * kChunk;
  G.rv = (r + 127) / 128 * 128;
  G.nch = G.rv / 128;
  G.ldq = G.rk + G.drk + 4;
  G.stage_bytes = std::max(
      kKeys * key_ld(G, ep) + (quant ? 2 * kKeys * 4 : 0),
      kKeys * key_ld(G, es));
  const size_t q = q_bytes(G) + kExBytes, st = G.stage_bytes;
  G.stages = r > kMaxR ? 0
             : q + 2 * st <= kMaxSmem ? 2
             : q + st <= kMaxSmem    ? 1
                                     : 0;
  G.ex_off = (int)(q_bytes(G) + (size_t)G.stages * st);
  G.scale = scale;
  return G;
}

inline size_t smem_bytes(const Geo& G) { return G.ex_off + kExBytes; }

// Bytes of an element of type code `dtype` (common.cuh), 0 if unknown.
inline int elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : dtype == kI8 ? 1 : 0;
}

// The piece size for rows of `bytes` bytes at `base` (every row's address
// is base + a multiple of bytes).
inline int piece_for(const void* base, size_t bytes, int elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (bytes % 16 == 0 && a % 16 == 0) return 16;
  if (bytes % 4 == 0 && a % 4 == 0) return 4;
  return elem;
}

// ---------------------------------------------------------------- copies
// One `piece`-byte copy from s (ok) or of zeros.
__device__ __forceinline__ void copy_piece(unsigned char* d,
                                           const unsigned char* s, bool ok,
                                           int piece, const void* any) {
  if (piece == 16) {
    cp_async16(d, ok ? s : any, ok ? 16 : 0);
  } else if (piece == 4) {
    cp_async4(d, ok ? s : any, ok ? 4 : 0);
  } else if (piece == 2) {
    *reinterpret_cast<uint16_t*>(d) =
        ok ? *reinterpret_cast<const uint16_t*>(s) : 0;
  } else {
    *d = ok ? *s : 0;
  }
}

// Stage `rows` rows into shared memory (rows `ld` bytes apart): row i takes
// the first `vbytes` bytes at src(i) (nullptr: none), the rest of its
// `tbytes` is zero-filled.
template <typename Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ld,
                                           int rows, int vbytes, int tbytes,
                                           int piece, const void* any,
                                           Src src) {
  if (tbytes == 0) return;
  const int per = tbytes / piece;
  if (kThreads % per == 0) {   // a fixed piece per thread: no division
    const int off = (threadIdx.x % per) * piece;
    for (int i = threadIdx.x / per; i < rows; i += kThreads / per) {
      const unsigned char* s = src(i);
      copy_piece(dst + (size_t)i * ld + off, s + off,
                 s != nullptr && off < vbytes, piece, any);
    }
    return;
  }
  for (int k = threadIdx.x; k < rows * per; k += kThreads) {
    const int i = k / per, off = (k - i * per) * piece;
    const unsigned char* s = src(i);
    copy_piece(dst + (size_t)i * ld + off, s + off,
               s != nullptr && off < vbytes, piece, any);
  }
}

template <typename T>
__device__ __forceinline__ const unsigned char* bytes_of(const T* p) {
  return reinterpret_cast<const unsigned char*>(p);
}

// The block's query rows: row i < nrows from q_lat + i * r and q_pe + i *
// dr, the rest zero.
__device__ __forceinline__ void stage_queries(float* qs, const Geo& G,
                                              const float* q_lat,
                                              const float* q_pe, int nrows) {
  unsigned char* d = reinterpret_cast<unsigned char*>(qs);
  stage_rows(d, G.ldq * 4, kRows, G.r * 4, G.rk * 4, G.pq, q_lat,
             [&](int i) -> const unsigned char* {
               return i < nrows ? bytes_of(q_lat + (size_t)i * G.r) : nullptr;
             });
  stage_rows(d + G.rk * 4, G.ldq * 4, kRows, G.dr * 4, G.drk * 4, G.pqe,
             q_pe, [&](int i) -> const unsigned char* {
               return i < nrows ? bytes_of(q_pe + (size_t)i * G.dr) : nullptr;
             });
}

// One key tile: row i from latent row row(i) of ckv [*, r] / kpe [*, dr]
// (row(i) < 0: zeros), with `cs`/`ps` (int8 pools) the rows' scales after
// the tile's rows.
template <typename T, typename Row>
__device__ __forceinline__ void stage_keys(unsigned char* kd, const Geo& G,
                                           const T* ckv, const T* kpe,
                                           const float* cs, const float* ps,
                                           int pc, int pp, Row row) {
  constexpr int es = sizeof(T);
  const int ld = key_ld(G, es);
  stage_rows(kd, ld, kKeys, G.r * es, G.rv * es, pc, ckv,
             [&](int i) -> const unsigned char* {
               const long long k = row(i);
               return k < 0 ? nullptr : bytes_of(ckv + k * G.r);
             });
  stage_rows(kd + G.rv * es, ld, kKeys, G.dr * es, G.drk * es, pp, kpe,
             [&](int i) -> const unsigned char* {
               const long long k = row(i);
               return k < 0 ? nullptr : bytes_of(kpe + k * G.dr);
             });
  if (cs != nullptr) {
    unsigned char* sd = kd + kKeys * ld;
    stage_rows(sd, 4, kKeys, 4, 4, 4, cs,
               [&](int i) -> const unsigned char* {
                 const long long k = row(i);
                 return k < 0 ? nullptr : bytes_of(cs + k);
               });
    stage_rows(sd + 4 * kKeys, 4, kKeys, 4, 4, 4, ps,
               [&](int i) -> const unsigned char* {
                 const long long k = row(i);
                 return k < 0 ? nullptr : bytes_of(ps + k);
               });
  }
}

// The key ring: issue(i, stage) stages tile i, step(i, tile) computes it.
// Copies the caller issued before (the query tile) join tile 0's group.
template <typename Issue, typename Step>
__device__ __forceinline__ void run_ring(const Geo& G, unsigned char* ring,
                                         int n_tiles, Issue issue,
                                         Step step) {
  if (n_tiles > 0) issue(0, 0);
  cp_commit();
  for (int i = 0; i < n_tiles; ++i) {
    const int st = G.stages == 2 ? (i & 1) : 0;
    if (G.stages == 2) {
      if (i + 1 < n_tiles) issue(i + 1, (i + 1) & 1);
      cp_commit();
      cp_wait<1>();          // tile i (and Q) landed: this thread's copies
    } else {
      cp_wait<0>();
    }
    __syncthreads();         // everyone's copies
    step(i, ring + (size_t)st * G.stage_bytes);
    __syncthreads();         // the stage is free for the next copies
    if (G.stages == 1 && i + 1 < n_tiles) {
      issue(i + 1, 0);
      cp_commit();
    }
  }
  cp_wait<0>();
}

// ------------------------------------------------------------ tensor cores
// x = big + small: big is x cut to tf32 (its low 13 mantissa bits
// cleared), small = x - big exactly; the MMA reads small's top 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// (x, y) = hi + mid + lo exactly, three bf16x2 terms cut by bit mask
// (each term x's top 8 significant bits left, the rest exact in f32), so
// no conversion instruction runs: the high halves pair up by one byte
// permute.
__device__ __forceinline__ uint32_t high_halves(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const uint32_t hx = __float_as_uint(x) & 0xffff0000u;
  const uint32_t hy = __float_as_uint(y) & 0xffff0000u;
  const float rx = x - __uint_as_float(hx), ry = y - __uint_as_float(hy);
  const uint32_t mx = __float_as_uint(rx) & 0xffff0000u;
  const uint32_t my = __float_as_uint(ry) & 0xffff0000u;
  hi = high_halves(hx, hy);
  mid = high_halves(mx, my);
  lo = high_halves(__float_as_uint(rx - __uint_as_float(mx)),
                   __float_as_uint(ry - __uint_as_float(my)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An int8 code as f32 bits, exactly, without a conversion instruction:
// 2^23 + 128 + c is exact in f32 (one integer add to its bits), minus
// 2^23 + 128 leaves c; |c| <= 128 also makes it exact in bf16 (its high
// half).
__device__ __forceinline__ uint32_t code_bits(int c) {
  return __float_as_uint(__int_as_float(0x4B000080 + c) - 8388736.f);
}

// Two consecutive staged elements as a bf16x2 (exact: bf16 values or int8
// codes); two elements of different rows likewise.
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return high_halves(code_bits(c.x), code_bits(c.y));
}
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(a) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(b) << 16);
}
__device__ __forceinline__ uint32_t pair(const int8_t* a, const int8_t* b) {
  return high_halves(code_bits(*a), code_bits(*b));
}

// s[nt] (C fragments of kN n-tiles of 8 keys, the first `ntl` computed)
// += this warp's 16 query rows (f32, row stride ldq) . the staged key rows
// (type KT, stride ldk elements), over `depth` (a multiple of kChunk)
// dimensions.  Lane (g, tq) = (lane / 4, lane % 4).
template <typename KT, int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4],
                                       const float* __restrict__ qw, int ldq,
                                       const KT* __restrict__ kt, int ldk,
                                       int depth, int ntl, int g, int tq) {
  for (int c0 = 0; c0 < depth; c0 += kChunk) {
    // the three product terms in their own accumulators (three short
    // dependency chains in place of one long one)
    float pa[kN][4], pb[kN][4], pc[kN][4];
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[nt][e] = pb[nt][e] = pc[nt][e] = 0.f;
    if constexpr (std::is_same<KT, float>::value) {
#pragma unroll
      for (int k0 = c0; k0 < c0 + kChunk; k0 += 8) {
        uint32_t ab[4], as[4];
        split_tf32(qw[g * ldq + k0 + tq], ab[0], as[0]);
        split_tf32(qw[(g + 8) * ldq + k0 + tq], ab[1], as[1]);
        split_tf32(qw[g * ldq + k0 + tq + 4], ab[2], as[2]);
        split_tf32(qw[(g + 8) * ldq + k0 + tq + 4], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < kN; ++nt) {
          if (nt < ntl) {
            const float* kr = kt + (nt * 8 + g) * ldk + k0;
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(kr[tq], bb0, bs0);
            split_tf32(kr[tq + 4], bb1, bs1);
            mma_tf32(pa[nt], as, bb0, bb1);
            mma_tf32(pb[nt], ab, bs0, bs1);
            mma_tf32(pc[nt], ab, bb0, bb1);
          }
        }
      }
    } else {
#pragma unroll
      for (int k0 = c0; k0 < c0 + kChunk; k0 += 16) {
        uint32_t a[3][4];
        const float* q0 = qw + g * ldq + k0 + 2 * tq;
        const float* q8 = q0 + 8 * ldq;
        const float2 x0 = *reinterpret_cast<const float2*>(q0);
        const float2 x1 = *reinterpret_cast<const float2*>(q8);
        const float2 x2 = *reinterpret_cast<const float2*>(q0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(q8 + 8);
        split_bf16(x0.x, x0.y, a[0][0], a[1][0], a[2][0]);
        split_bf16(x1.x, x1.y, a[0][1], a[1][1], a[2][1]);
        split_bf16(x2.x, x2.y, a[0][2], a[1][2], a[2][2]);
        split_bf16(x3.x, x3.y, a[0][3], a[1][3], a[2][3]);
#pragma unroll
        for (int nt = 0; nt < kN; ++nt) {
          if (nt < ntl) {
            const KT* kr = kt + (nt * 8 + g) * ldk + k0 + 2 * tq;
            const uint32_t b0 = pair(kr), b1 = pair(kr + 8);
            mma_bf16(pa[nt], a[2], b0, b1);
            mma_bf16(pb[nt], a[1], b0, b1);
            mma_bf16(pc[nt], a[0], b0, b1);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] += (pa[nt][e] + pb[nt][e]) + pc[nt][e];
  }
}

// o[n] (C fragments of the warp's value n-tiles, nch chunks of 8) += P .
// the staged value rows (type VT, stride ldv elements, starting at the
// warp's first column).  P's rows g and g + 8 are read from the exchange
// (xp: row g, rows kPld apart), its first ntl n-tiles of keys live.  The
// tensor cores truncate each MMA's sum into its accumulator, always
// towards 0, so o carried over a long key range in one accumulator drifts
// with its length (B9 behind 4096 / 8192 f32 prefix tokens read 1.06 /
// 1.63 of the 1e-5 tolerance against float64, launch/mla_shares.py): each
// tile's 32 keys are summed in a fresh accumulator, kFreshNB value n-tiles
// at a time, and added to o in f32.  The key steps run as a loop, not
// unrolled (unrolled at 4 n-tiles a block, B9 ran 4-6 % slower).
template <typename VT>
__device__ __forceinline__ void values(float (&o)[kNT][4],
                                       const float* __restrict__ xp,
                                       const VT* __restrict__ vt, int ldv,
                                       int nch, int ntl, int g, int tq) {
#pragma unroll
  for (int nb = 0; nb < kNT; nb += kFreshNB) {
    if (nb >= 8 * nch) continue;
    float t[kFreshNB][4] = {};
    if constexpr (std::is_same<VT, float>::value) {
      // MMA k tq <-> key 8j + 2tq, k tq + 4 <-> key 8j + 2tq + 1
#pragma unroll 1
      for (int j = 0; j < ntl; ++j) {
        const float2 a0 =
            *reinterpret_cast<const float2*>(xp + 8 * j + 2 * tq);
        const float2 a1 =
            *reinterpret_cast<const float2*>(xp + 8 * kPld + 8 * j + 2 * tq);
        uint32_t ab[4], as[4];
        split_tf32(a0.x, ab[0], as[0]);
        split_tf32(a1.x, ab[1], as[1]);
        split_tf32(a0.y, ab[2], as[2]);
        split_tf32(a1.y, ab[3], as[3]);
        const float* v0 = vt + (8 * j + 2 * tq) * ldv + g + 8 * nb;
        uint32_t bb0[kFreshNB], bs0[kFreshNB], bb1[kFreshNB], bs1[kFreshNB];
#pragma unroll
        for (int i = 0; i < kFreshNB; ++i) {
          split_tf32(v0[8 * i], bb0[i], bs0[i]);
          split_tf32(v0[ldv + 8 * i], bb1[i], bs1[i]);
        }
#pragma unroll
        for (int i = 0; i < kFreshNB; ++i) mma_tf32(t[i], as, bb0[i], bb1[i]);
#pragma unroll
        for (int i = 0; i < kFreshNB; ++i) mma_tf32(t[i], ab, bs0[i], bs1[i]);
#pragma unroll
        for (int i = 0; i < kFreshNB; ++i) mma_tf32(t[i], ab, bb0[i], bb1[i]);
      }
    } else {
#pragma unroll 1
      for (int k0 = 0; k0 < 8 * ntl; k0 += 16) {
        const float* x0 = xp + k0 + 2 * tq;
        const float* x8 = x0 + 8 * kPld;
        const float2 a0 = *reinterpret_cast<const float2*>(x0);
        const float2 a1 = *reinterpret_cast<const float2*>(x8);
        const float2 a2 = *reinterpret_cast<const float2*>(x0 + 8);
        const float2 a3 = *reinterpret_cast<const float2*>(x8 + 8);
        uint32_t a[3][4];
        split_bf16(a0.x, a0.y, a[0][0], a[1][0], a[2][0]);
        split_bf16(a1.x, a1.y, a[0][1], a[1][1], a[2][1]);
        split_bf16(a2.x, a2.y, a[0][2], a[1][2], a[2][2]);
        split_bf16(a3.x, a3.y, a[0][3], a[1][3], a[2][3]);
        const VT* r0 = vt + (k0 + 2 * tq) * ldv + g + 8 * nb;
        const VT* r8 = r0 + 8 * ldv;
        uint32_t b0[kFreshNB], b1[kFreshNB];
#pragma unroll
        for (int i = 0; i < kFreshNB; ++i) {
          b0[i] = pair(r0 + 8 * i, r0 + ldv + 8 * i);
          b1[i] = pair(r8 + 8 * i, r8 + ldv + 8 * i);
        }
#pragma unroll
        for (int x = 2; x >= 0; --x)
#pragma unroll
          for (int i = 0; i < kFreshNB; ++i) mma_bf16(t[i], a[x], b0[i], b1[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFreshNB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb + i][e] += t[i][e];
  }
}

// The warp's running state: o (its 16 rows x its value columns), the row
// max m and this thread's partial row sum lp for rows g and g + 8.
struct Warp {
  int rg, vh;  // row group (w % 4) and half (w / 4)
  int wr;      // first query row of the block this warp holds
  int col0;    // first value column
  int g, tq;   // lane / 4, lane % 4
};

__device__ __forceinline__ Warp warp_of(const Geo& G) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Warp w;
  w.rg = warp % 4;
  w.vh = warp / 4;
  w.wr = 16 * w.rg;
  w.col0 = w.vh * 64 * G.nch;
  w.g = lane >> 2;
  w.tq = lane & 3;
  return w;
}

// Synchronise the two warps of a row group (named barrier 1 + rg; 0 is
// __syncthreads').
__device__ __forceinline__ void pair_sync(const Warp& w) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + w.rg) : "memory");
}

// One key tile for this warp: the scores of its 16 keys, masks, the
// exchange of row maxima and P with its partner, the online-softmax step
// and the value product over all 32 keys.  kd: the staged tile (rows of
// type KT); ex: the exchange; nlive >= 1 keys live (the rest masked and
// skipped); valid(e, c): whether fragment element e (rows g for e < 2,
// g + 8 else) may see key c of the tile.  kQuant: an int8 tile, its ckv /
// kpe row scales after the rows.  Both warps of the pair must call it.
template <typename KT, bool kQuant, typename Valid>
__device__ __forceinline__ void tile_step(float (&o)[kNT][4], float (&m)[2],
                                          float (&lp)[2], const float* qs,
                                          const unsigned char* kd, float* ex,
                                          const Geo& G, const Warp& w,
                                          int nlive, Valid valid) {
  const int ldk = key_ld(G, sizeof(KT)) / (int)sizeof(KT);
  const KT* kt = reinterpret_cast<const KT*>(kd);
  const KT* ko = kt + 16 * w.vh * ldk;         // this warp's 16 keys
  const float* qw = qs + w.wr * G.ldq;
  const int ntl = (nlive + 7) / 8;              // live n-tiles of the tile
  const int own = 2 * w.vh;                     // this warp's first n-tile
  const int ntl_own = min(max(ntl - own, 0), 2);
  const int g = w.g, tq = w.tq;
  float s[2][4], t[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
  if (ntl_own > 0) {
    scores<KT, 2>(s, qw, G.ldq, ko, ldk, G.rk, ntl_own, g, tq);
    // fp tiles sum the rope part into the same accumulator; int8 tiles
    // keep it apart for its own row scale
    if constexpr (kQuant)
      scores<KT, 2>(t, qw + G.rk, G.ldq, ko + G.rv, ldk, G.drk, ntl_own, g,
                    tq);
    else
      scores<KT, 2>(s, qw + G.rk, G.ldq, ko + G.rv, ldk, G.drk, ntl_own, g,
                    tq);
  }
  const float* cs =
      reinterpret_cast<const float*>(kd + (size_t)kKeys * ldk * sizeof(KT));
  const float* ps = cs + kKeys;
  uint32_t ok_bits = 0;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * (own + j) + 2 * tq + (e & 1);
      const bool ok = j < ntl_own && valid(e, c);
      float v = kQuant ? (s[j][e] * cs[c] + t[j][e] * ps[c]) * G.scale
                       : s[j][e] * G.scale;
      s[j][e] = ok ? v : REPRO_NEG_INF;
      ok_bits |= (ok ? 1u : 0u) << (4 * j + e);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float* xp = ex;                               // P [kRows][kPld]
  float* xm = ex + kRows * kPld;                // row maxima [2][kRows]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (tq == 0) xm[w.vh * kRows + w.wr + g + 8 * r] = mx[r];
  }
  pair_sync(w);
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], xm[(w.vh ^ 1) * kRows + w.wr + g + 8 * r]);
    corr[r] = expf(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = (ok_bits >> (4 * j + e)) & 1u ? expf(s[j][e] - mx[e >> 1])
                                              : 0.f;
      sum[e >> 1] += p;
      // l takes the unscaled exp; the value weights carry the ckv scale
      if (kQuant) p *= cs[8 * (own + j) + 2 * tq + (e & 1)];
      s[j][e] = p;
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(xp + (w.wr + g + 8 * r) * kPld +
                                 8 * (own + j) + 2 * tq) =
          make_float2(s[j][2 * r], s[j][2 * r + 1]);
  pair_sync(w);
#pragma unroll
  for (int r = 0; r < 2; ++r) lp[r] = lp[r] * corr[r] + sum[r];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
  values<KT>(o, xp + (w.wr + g) * kPld, kt + w.col0, ldk, G.nch, ntl, g,
             tq);
}

// Zeroed accumulators and the empty softmax state.
__device__ __forceinline__ void init_state(float (&o)[kNT][4], float (&m)[2],
                                           float (&lp)[2]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = REPRO_NEG_INF;
  lp[0] = lp[1] = 0.f;
}

// The softmax sums of rows g and g + 8: the quad's partial sums of each
// warp of the pair, the two halves added in a fixed order (so both warps
// hold the same bits).  After the key loop (the ring's last barrier keeps
// the exchange free).
__device__ __forceinline__ void row_sums(float (&l)[2], const float (&lp)[2],
                                         float* ex, const Warp& w) {
  float* xl = ex + kRows * kPld;                // [2][kRows]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = lp[r] + __shfl_xor_sync(0xffffffffu, lp[r], 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (w.tq == 0) xl[w.vh * kRows + w.wr + w.g + 8 * r] = v;
  }
  pair_sync(w);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w.wr + w.g + 8 * r;
    l[r] = xl[row] + xl[kRows + row];
  }
}

// Write this warp's columns of row g + 8 * rr (< r) to dst[col] as
// o / den.
__device__ __forceinline__ void put_row(float* __restrict__ dst,
                                        const float (&o)[kNT][4], int rr,
                                        float den, const Geo& G,
                                        const Warp& w) {
#pragma unroll
  for (int c = 0; c < kNT / 8; ++c) {
    if (c >= G.nch) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int n = 8 * c + jn;
      const int col = w.col0 + 8 * n + 2 * w.tq;
      if (col < G.r) dst[col] = o[n][2 * rr] / den;
      if (col + 1 < G.r) dst[col + 1] = o[n][2 * rr + 1] / den;
    }
  }
}

}  // namespace mla_tc
