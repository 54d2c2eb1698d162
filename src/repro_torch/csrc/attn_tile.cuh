// The GQA attention tile on the tensor cores: the shared body of K3
// (gqa_paged_prefill.cu, a chunk after paged prefix pages) and B4
// (flash_attention.cu, a whole sequence).
//
// A block holds 64 query rows of the flattened T*grp axis (row R = t * grp +
// g: the grp query heads of one KV head share every staged key tile), 4
// warps of 16 rows, as in FlashAttention-2.  Key tiles of 64 rows stream
// through a shared-memory ring filled by cp.async (16-byte pieces where the
// rows allow, else 4-byte; 2-byte synchronous copies for odd bf16 widths);
// with two stages the next tile is in flight while the current one is
// computed.  Widths are zero-padded to a multiple of 16 in shared memory, so
// any head width runs; the callers cut the value columns into slices of
// kDV <= 128 (a block each, recomputing the scores).  tile_step is one key
// tile for one warp: scores, masks, the online-softmax step on the
// accumulator fragments in registers (quad shuffles for the row max; each
// thread keeps a partial row sum, summed across the quad at the end) and
// the value product.
//
// Arithmetic.  S = Q K^T and O += P V run on mma.sync.  The tolerance
// against the reference (1e-5 of max |out| in f32) rules out plain TF32
// (10-bit mantissa), so every f32 product is exact or nearly so:
//  - an f32 x f32 product (f32 Q against f32 K, f32 P against f32 V) is
//    3xTF32 on m16n8k8: each operand x = big + small, big = x cut to tf32,
//    small = x - big (cut to tf32 by the MMA), and the MMA sums small*big
//    + big*small + big*big (about 2^-20 relative per product);
//  - f32 Q against keys exact in bf16 (bf16 K, int8 codes, |c| <= 128): Q is
//    split into three bf16 terms hi + mid + lo that hold its 24-bit
//    significand exactly, and three bf16 m16n8k16 MMAs sum exact products;
//    P against bf16 values likewise;
//  - bf16 Q against bf16 K (B4's bf16 instance): both exact in bf16, so S is
//    one m16n8k16 MMA per k-step with f32 accumulation (fragments by
//    ldmatrix), and P against bf16 values takes kBf16QPTerms bf16 terms of
//    P cut by bit mask (value fragments by ldmatrix.trans; the last
//    term leaves under 2^-15 of each weight; the output is rounded to bf16,
//    2^-9, and checked at 1e-2).
// For 3xTF32 P V the MMA's k order over a key tile is permuted (MMA k t <->
// key 2t, t + 4 <-> key 2t + 1) so the score accumulators serve as the A
// operand without a shuffle; the bf16 m16n8k16 A layout takes the score
// fragments in key order as they stand.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace attn_tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows per block (tensor cores)
constexpr int kKeys = 64;            // keys per tile
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory per block
constexpr size_t kSmemPerSM = 233472;  // shared memory of one SM
constexpr size_t kBlockReserve = 1024;  // the runtime's share per block
constexpr int kBf16QPTerms = 2;      // P's bf16 terms against bf16 Q
constexpr int kValueGroup = 32;      // exact P.V: keys per fresh accumulator
// exact P.V: n-tiles summed side by side (3xTF32 / the bf16 terms), so that
// back-to-back MMAs feed independent accumulators; the bf16 terms' tile
// keeps fewer, since its int8-pool instances hold more registers
constexpr int kFreshNB = 4;
constexpr int kFreshNBBf16 = 2;

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

// Stage `rows` rows into shared memory (rows `ld` bytes apart): row r takes
// the first `vbytes` bytes at src(r) (nullptr: none), the rest of its
// `tbytes` is zero-filled.  `piece` is the copy's size: 16 or 4 bytes by
// cp.async (vbytes, tbytes and the rows' addresses multiples of it), or 2 /
// 1 by synchronous copies.
template <typename Src>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int ld,
                                           int rows, int vbytes, int tbytes,
                                           int piece, const void* any,
                                           Src src) {
  const int per = tbytes / piece;
  if (kThreads % per == 0) {   // a fixed piece per thread: no division
    const int off = (threadIdx.x % per) * piece;
    for (int r = threadIdx.x / per; r < rows; r += kThreads / per) {
      const unsigned char* s = src(r);
      copy_piece(dst + (size_t)r * ld + off, s + off,
                 s != nullptr && off < vbytes, piece, any);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, off = (i - r * per) * piece;
    const unsigned char* s = src(r);
    copy_piece(dst + (size_t)r * ld + off, s + off,
               s != nullptr && off < vbytes, piece, any);
  }
}

// The piece size for rows of `bytes` bytes at `base` (every row's address
// is base + a multiple of bytes, or of a row stride that bytes divides).
inline int piece_for(const void* base, size_t bytes, int elem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  if (bytes % 16 == 0 && a % 16 == 0) return 16;
  if (bytes % 4 == 0 && a % 4 == 0) return 4;
  return elem;
}

// Ring stages for a block of `q_bytes` of queries and `stage_bytes` a key
// tile: two only where two such blocks still share an SM (f32 tiles of Dh =
// 128 take one: two blocks of one stage each were 1.5x faster on an H100
// than one block of two, PERF.md), else one; 0 where one stage does not
// fit (the callers' CUDA-core path).
inline int ring_stages(size_t q_bytes, size_t stage_bytes) {
  if (2 * (q_bytes + 2 * stage_bytes + kBlockReserve) <= kSmemPerSM) return 2;
  return q_bytes + stage_bytes <= kMaxSmem ? 1 : 0;
}

// ------------------------------------------------------------ tensor cores
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// x = big + small: big is x cut to tf32 (its low 13 mantissa bits
// cleared), small = x - big exactly (|small| < 2^-10 |x|); the MMA reads a
// tf32 operand's top 19 bits, so small loses under 2^-21 |x|.  Two ALU
// operations, where cvt.rna.tf32 would take the conversion pipe.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// (x, y) = hi + mid + lo exactly, three bf16x2 terms
__device__ __forceinline__ void split_bf16(float x, float y,
                                           uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x, y);
  float2 f = __bfloat1622float2(a);
  x -= f.x;
  y -= f.y;
  __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  f = __bfloat1622float2(b);
  hi = as_u32(a);
  mid = as_u32(b);
  lo = as_u32(__floats2bfloat162_rn(x - f.x, y - f.y));
}
// (x, y) ~ t[0] + ... + t[kN - 1], bf16x2 terms cut by bit mask: each term
// keeps the top 8 significant bits of what the earlier ones left (no
// conversion instruction; the high halves pair up by one byte permute), so
// kN terms leave under 2^(1 - 8 kN) of |x|, always towards 0.
template <int kN>
__device__ __forceinline__ void split_bf16_mask(float x, float y,
                                                uint32_t (&t)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const uint32_t hx = __float_as_uint(x) & 0xffff0000u;
    const uint32_t hy = __float_as_uint(y) & 0xffff0000u;
    t[i] = __byte_perm(hx, hy, 0x7632);
    x -= __uint_as_float(hx);
    y -= __uint_as_float(hy);
  }
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

// 2^x on the SFU (ex2.approx.ftz: under 2^-22 relative; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands out their transposes.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p)));
}

// Two consecutive staged elements as a bf16x2 (exact: bf16 values or int8
// codes); two elements of different rows likewise.
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return as_u32(__floats2bfloat162_rn((float)c.x, (float)c.y));
}
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(a) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(b) << 16);
}
__device__ __forceinline__ uint32_t pair(const int8_t* a, const int8_t* b) {
  return as_u32(__floats2bfloat162_rn((float)*a, (float)*b));
}

// s[nt] (the C fragments of 8 n-tiles of 8 keys) = this warp's 16 query
// rows (type QT, row stride ldq) . the staged key tile (rows of type KT,
// stride ldk elements), over Dhp (a multiple of 16) dimensions.  Lane (g,
// tq) = (lane / 4, lane % 4).
template <typename KT, typename QT>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const QT* __restrict__ qw, int ldq,
                                       const KT* __restrict__ kt, int ldk,
                                       int Dhp, int g, int tq) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    static_assert(std::is_same<KT, __nv_bfloat16>::value,
                  "bf16 queries take bf16 keys");
    // by ldmatrix: Q's A fragment (rows l % 16, k + 8 (l / 16)) in one,
    // the B fragments of two n-tiles (keys 8 (l / 16) + l % 8, k + 8 ((l /
    // 8) % 2)) in another
    const int l = 4 * g + tq;
    const QT* qa = qw + (l & 15) * ldq + 8 * (l >> 4);
    const KT* ka = kt + (8 * (l >> 4) + (l & 7)) * ldk + 8 * ((l >> 3) & 1);
    for (int k0 = 0; k0 < Dhp; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, qa + k0);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t b[4];
        ldsm_x4(b, ka + nt * 8 * ldk + k0);
        mma_bf16(s[nt], a, b[0], b[1]);
        mma_bf16(s[nt + 1], a, b[2], b[3]);
      }
    }
  } else if constexpr (std::is_same<KT, float>::value) {
    for (int k0 = 0; k0 < Dhp; k0 += 8) {
      uint32_t ab[4], as[4];
      split_tf32(qw[g * ldq + k0 + tq], ab[0], as[0]);
      split_tf32(qw[(g + 8) * ldq + k0 + tq], ab[1], as[1]);
      split_tf32(qw[g * ldq + k0 + tq + 4], ab[2], as[2]);
      split_tf32(qw[(g + 8) * ldq + k0 + tq + 4], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* kr = kt + (nt * 8 + g) * ldk + k0;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kr[tq], bb0, bs0);
        split_tf32(kr[tq + 4], bb1, bs1);
        mma_tf32(s[nt], as, bb0, bb1);
        mma_tf32(s[nt], ab, bs0, bs1);
        mma_tf32(s[nt], ab, bb0, bb1);
      }
    }
  } else {
    for (int k0 = 0; k0 < Dhp; k0 += 16) {
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
      for (int nt = 0; nt < 8; ++nt) {
        const KT* kr = kt + (nt * 8 + g) * ldk + k0 + 2 * tq;
        const uint32_t b0 = pair(kr), b1 = pair(kr + 8);
        mma_bf16(s[nt], a[2], b0, b1);
        mma_bf16(s[nt], a[1], b0, b1);
        mma_bf16(s[nt], a[0], b0, b1);
      }
    }
  }
}

// o[n] (C fragments of kNT n-tiles of 8 value columns) += p . the staged
// value tile (rows of type VT, stride ldv elements); p holds the tile's
// value weights in the score fragments' layout.  Against bf16 values or
// int8 codes P takes kPTerms bf16 terms: 3 exact ones (split_bf16), or
// fewer cut by bit mask.  The exact products (3xTF32, the 3 bf16 terms)
// sum each kValueGroup keys in a fresh accumulator, added to o in f32: the
// tensor cores truncate each MMA's sum into its accumulator, always towards
// 0, so one accumulator carried over a 2048-key row (768 3xTF32 MMAs)
// shrinks |o| by about 3e-5 of itself; a group's 12 MMAs leave about 5e-7.
// With bf16 terms one accumulator crosses the 1e-5 tolerance between 4096
// and 8192 keys (launch/k3_shares.py).  P's masked terms (bf16 Q, B4) keep
// one accumulator: their tolerance is bf16's.
template <int kNT, typename VT, int kPTerms = 3>
__device__ __forceinline__ void values(float (&o)[kNT][4],
                                       const float (&p)[8][4],
                                       const VT* __restrict__ vt, int ldv,
                                       int g, int tq) {
  if constexpr (std::is_same<VT, float>::value) {
    // each kValueGroup keys in a fresh accumulator, added to o in f32,
    // kFreshNB n-tiles at a time
    constexpr int kH = kValueGroup / 8;
    static_assert(kNT % kFreshNB == 0, "n-tiles come in blocks");
#pragma unroll
    for (int jp = 0; jp < 8 / kH; ++jp) {
      uint32_t ab[kH][4], as[kH][4];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const float* pj = p[kH * jp + h];
        split_tf32(pj[0], ab[h][0], as[h][0]);
        split_tf32(pj[2], ab[h][1], as[h][1]);
        split_tf32(pj[1], ab[h][2], as[h][2]);
        split_tf32(pj[3], ab[h][3], as[h][3]);
      }
#pragma unroll
      for (int nb = 0; nb < kNT; nb += kFreshNB) {
        float t[kFreshNB][4] = {};
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const float* v0 =
              vt + (8 * (kH * jp + h) + 2 * tq) * ldv + g + 8 * nb;
          uint32_t bb0[kFreshNB], bs0[kFreshNB], bb1[kFreshNB],
              bs1[kFreshNB];
#pragma unroll
          for (int i = 0; i < kFreshNB; ++i) {
            split_tf32(v0[8 * i], bb0[i], bs0[i]);
            split_tf32(v0[ldv + 8 * i], bb1[i], bs1[i]);
          }
#pragma unroll
          for (int i = 0; i < kFreshNB; ++i)
            mma_tf32(t[i], as[h], bb0[i], bb1[i]);
#pragma unroll
          for (int i = 0; i < kFreshNB; ++i)
            mma_tf32(t[i], ab[h], bs0[i], bs1[i]);
#pragma unroll
          for (int i = 0; i < kFreshNB; ++i)
            mma_tf32(t[i], ab[h], bb0[i], bb1[i]);
        }
#pragma unroll
        for (int i = 0; i < kFreshNB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nb + i][e] += t[i][e];
      }
    }
  } else if constexpr (kPTerms == 3) {
    constexpr int kH = kValueGroup / 16;
    static_assert(kNT % kFreshNBBf16 == 0, "n-tiles come in blocks");
#pragma unroll
    for (int kp = 0; kp < 4 / kH; ++kp) {
      uint32_t a[kH][3][4];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int kk = kH * kp + h;
        split_bf16(p[2 * kk][0], p[2 * kk][1], a[h][0][0], a[h][1][0],
                   a[h][2][0]);
        split_bf16(p[2 * kk][2], p[2 * kk][3], a[h][0][1], a[h][1][1],
                   a[h][2][1]);
        split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], a[h][0][2],
                   a[h][1][2], a[h][2][2]);
        split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], a[h][0][3],
                   a[h][1][3], a[h][2][3]);
      }
#pragma unroll
      for (int nb = 0; nb < kNT; nb += kFreshNBBf16) {
        float t[kFreshNBBf16][4] = {};
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const VT* r0 =
              vt + (16 * (kH * kp + h) + 2 * tq) * ldv + g + 8 * nb;
          const VT* r8 = r0 + 8 * ldv;
          uint32_t b0[kFreshNBBf16], b1[kFreshNBBf16];
#pragma unroll
          for (int i = 0; i < kFreshNBBf16; ++i) {
            b0[i] = pair(r0 + 8 * i, r0 + ldv + 8 * i);
            b1[i] = pair(r8 + 8 * i, r8 + ldv + 8 * i);
          }
#pragma unroll
          for (int x = 2; x >= 0; --x)
#pragma unroll
            for (int i = 0; i < kFreshNBBf16; ++i)
              mma_bf16(t[i], a[h][x], b0[i], b1[i]);
        }
#pragma unroll
        for (int i = 0; i < kFreshNBBf16; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nb + i][e] += t[i][e];
      }
    }
  } else {
    // bf16 Q (B4): P in kPTerms terms by bit mask, lowest first; the value
    // B fragments of two n-tiles in one ldmatrix.trans (keys 16 kk + l % 16,
    // columns 8 n + 8 (l / 16))
    static_assert(std::is_same<VT, __nv_bfloat16>::value && kNT % 2 == 0,
                  "bf16 queries take bf16 values");
    const int l = 4 * g + tq;
    const VT* va = vt + (l & 15) * ldv + 8 * (l >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[kPTerms][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {     // fragment f: n-tile 2kk + f / 2
        uint32_t t[kPTerms];
        const float* pf = p[2 * kk + f / 2] + 2 * (f & 1);
        split_bf16_mask<kPTerms>(pf[0], pf[1], t);
#pragma unroll
        for (int i = 0; i < kPTerms; ++i) a[i][f] = t[i];
      }
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, va + 16 * kk * ldv + 8 * n);
#pragma unroll
        for (int i = kPTerms - 1; i >= 0; --i) {
          mma_bf16(o[n], a[i], b[0], b[1]);
          mma_bf16(o[n + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
}

// Launch geometry, computed on the host.
struct Geo {
  int T, Hkv, grp, Dh, Dv, PS, P;
  int Dhp;            // Dh rounded up to 16
  int n_vs;           // value slices of kDV columns
  int stages;         // ring stages (1 or 2)
  int ldk, ldv;       // staged key / value row strides, bytes
  int stage_bytes;
  int pq, pkp, pvp, pks, pvs;   // copy pieces: q, pool K/V, suffix K/V
  float scale;
};

// One key tile for this warp: scores, masks, the online-softmax step and
// the value product.  kPre: keys are valid below lim only (K3's prefix
// tiles, lim = prefix_len; B4's non-causal tiles, lim = S), else causally
// (valid when j0 + c <= the row's t and < lim: K3's suffix tiles, lim =
// chunk_len; B4's causal tiles, lim = S).  ksc / vsc: the tile rows' int8
// scales (kQuant).  qw: the warp's 16 query rows, f32 or bf16 (QT).
// kFast (B4): a tile whose every key is valid for this thread's rows skips
// the masks; the softmax runs in base 2 (scores scaled by scale * log2(e),
// exponentials by ex2: m holds the base-2 maximum).  K3 keeps the masks and
// expf.
template <typename KT, bool kPre, bool kQuant, int kNT, typename QT,
          bool kFast = false>
__device__ __forceinline__ void tile_step(
    float (&o)[kNT][4], float (&m)[2], float (&lp)[2], const QT* qw,
    int ldq, const unsigned char* kd, const unsigned char* vd,
    const float* ksc, const float* vsc, const Geo& G, int j0, int lim,
    int ta, int tb, int g, int tq) {
  constexpr int kPTerms =
      std::is_same<QT, __nv_bfloat16>::value ? kBf16QPTerms : 3;
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  scores<KT>(s, qw, ldq, reinterpret_cast<const KT*>(kd),
             G.ldk / (int)sizeof(KT), G.Dhp, g, tq);
  uint32_t valid = 0;
  float mx[2] = {m[0], m[1]};
  const float scale = kFast ? G.scale * 1.4426950408889634f : G.scale;
  // every key of the tile valid for this thread's rows (ta <= tb)
  const bool full = kFast && !kQuant &&
                    (kPre ? j0 + kKeys <= lim
                          : j0 + kKeys - 1 <= ta && j0 + kKeys <= lim);
  if (full) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] *= scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    valid = 0xffffffffu;
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * tq + (e & 1);
        const int key = j0 + c;
        const bool ok =
            kPre ? key < lim : key <= (e < 2 ? ta : tb) && key < lim;
        float v = s[nt][e] * scale;
        if (kPre && kQuant) v *= ksc[c];
        s[nt][e] = ok ? v : REPRO_NEG_INF;
        valid |= (ok ? 1u : 0u) << (4 * nt + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
  }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if constexpr (kFast)
      corr[r] = ex2(m[r] - mx[r]);
    else
      corr[r] = expf(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p;
      if constexpr (kFast)
        p = (valid >> (4 * nt + e)) & 1u ? ex2(s[nt][e] - mx[e >> 1]) : 0.f;
      else
        p = (valid >> (4 * nt + e)) & 1u ? expf(s[nt][e] - mx[e >> 1]) : 0.f;
      sum[e >> 1] += p;
      // l takes the unscaled exp; the value weights carry v_scale
      if (kPre && kQuant) p *= vsc[8 * nt + 2 * tq + (e & 1)];
      s[nt][e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) lp[r] = lp[r] * corr[r] + sum[r];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
  values<kNT, KT, kPTerms>(o, s, reinterpret_cast<const KT*>(vd),
                           G.ldv / (int)sizeof(KT), g, tq);
}

}  // namespace attn_tc
