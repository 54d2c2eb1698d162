// The staging ring shared by the port's int4-weight GEMM tiles: K1/B6 (W4A16,
// w4a16_tile.cuh) and B5/B7 (W4A8, w4a8_tile.cuh).  One copy of the
// cp.async copies, the copy lanes, the chunk geometry of a quantization
// group and the kernel that sums split-K partials.
//
// Chunks.  Weights use the reference's group-split packing: packed row r of
// group g holds weight row g*G + r in its low nibble and g*G + G/2 + r in its
// high nibble.  Any run of packed rows r..r+n of a group is therefore a
// closed set of k (weight rows r..r+n and G/2+r..G/2+r+n), so a ring stage
// holds a chunk of at most kMaxChunk packed rows (128 weight rows) of one
// group, and a group of G > 128 walks ceil(G/128) stages; the tiles fold a
// group into their accumulators once, at its last stage.  A chunk is padded
// to a multiple of the tile's k-step (8 packed rows for A16, 16 for A8): the
// padded packed rows and the matching X positions are zero-filled by the
// copies, and a zero X contributes nothing whatever its code folds to.  So
// every G % 8 == 0 is taken, as the reference takes any group.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace w4tc {
// internal linkage: K1, B5, B6 and B7 are separate libraries, each with its
// own CUDA runtime and kernels, so none may bind another's instantiations
namespace {

constexpr int kMaxChunk = 64;           // packed rows per stage (128 k)
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory per block

// In a ring of kStages stages: wait until at most kStages - 2 committed
// copy groups are still in flight (the oldest has landed).
template <int kStages>
__device__ __forceinline__ void cp_wait_ring() {
  cp_wait<kStages - 2>();
}

// One thread's share of copying [rows, row_bytes] in `chunk`-byte pieces
// (row_bytes / chunk <= threads): its byte within a row, its first row and
// the step to its next row; threads past the last whole row stay idle.
struct CopyLane {
  int col, row0, step;
  __device__ __forceinline__ CopyLane(int row_bytes, int chunk, int threads) {
    const int per_row = row_bytes / chunk;
    step = threads / per_row;
    col = (threadIdx.x % per_row) * chunk;
    row0 = (int)threadIdx.x < step * per_row ? (int)threadIdx.x / per_row
                                             : 1 << 30;
  }
};

// The byte offset of column byte `col` of staged packed row `r` under the
// A8 tile's swizzle: the 16-byte pieces of a row are permuted by
// 2 * ((r / 4) % 4), so the four rows 4 t4 + i that the four t4 lanes read
// in one k-step fall in four different banks (rows must be 128-byte
// multiples).
__device__ __forceinline__ int swizzle(int r, int col) {
  return col ^ (((r >> 2) & 3) << 5);
}

// Copy `rows` rows into shared memory (row stride `dst_stride`) from global
// rows `src_stride` bytes apart by 16-byte (vec16: source rows, stride and
// valid_bytes are 16-byte multiples) or 4-byte cp.async; per row only the
// first `valid_bytes` are read and only rows < valid_rows, the rest of the
// destination is zero-filled.  `swz`: place the pieces by swizzle().
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride,
                                          const unsigned char* src,
                                          size_t src_stride, int rows,
                                          int valid_rows, int valid_bytes,
                                          bool vec16, const CopyLane& l,
                                          bool swz = false) {
  for (int r = l.row0; r < rows; r += l.step) {
    const bool ok = r < valid_rows && l.col < valid_bytes;
    const unsigned char* s = ok ? src + r * src_stride + l.col : src;
    unsigned char* d = dst + r * dst_stride + (swz ? swizzle(r, l.col) : l.col);
    if (vec16)
      cp_async16(d, s, ok ? 16 : 0);
    else
      cp_async4(d, s, ok ? 4 : 0);
  }
}

// The chunks of a group of G weight rows for a tile whose k-step takes
// `step` packed rows: `per_group` chunks of at most kMaxChunk packed rows,
// each staged in `padded` rows (a multiple of `step`).
struct Chunking {
  int half, per_group, padded;
  __host__ __device__ Chunking(int G, int step)
      : half(G / 2),
        per_group((G / 2 + kMaxChunk - 1) / kMaxChunk),
        padded(((G / 2 < kMaxChunk ? G / 2 : kMaxChunk) + step - 1) / step *
               step) {}
  // packed rows of chunk c that hold weights (the rest are padding)
  __device__ __forceinline__ int valid(int c) const {
    return min(kMaxChunk, half - c * kMaxChunk);
  }
};

// The (group, chunk) that a ring stage holds, stepped in ring order
// without a division.
struct ChunkCursor {
  int g, c;
  __device__ __forceinline__ void next(int per_group) {
    if (++c == per_group) {
      c = 0;
      ++g;
    }
  }
};

// Bytes a thread's X copy lane spans per row: a chunk that is its whole,
// unpadded group is one run of G values (its low- and high-nibble rows are
// adjacent in X and in the stage); any other chunk is two runs of `padded`.
__host__ __device__ inline int x_copy_bytes(const Chunking& ch, int xsize) {
  return (ch.padded == ch.half ? 2 * ch.half : ch.padded) * xsize;
}

// Stage chunk c of group g of the X rows at `xg` (row stride `row_bytes`):
// the low-nibble run X[g*G + r0..] at `dst`, the high-nibble run
// X[g*G + G/2 + r0..] `padded` values after it, padding zero-filled.
__device__ __forceinline__ void copy_x_chunk(unsigned char* dst,
                                             int dst_stride,
                                             const unsigned char* xg,
                                             size_t row_bytes, int rows,
                                             int valid_rows,
                                             const Chunking& ch, int g, int c,
                                             int xsize, bool vec16,
                                             const CopyLane& l) {
  const unsigned char* src =
      xg + ((size_t)g * 2 * ch.half + (size_t)c * kMaxChunk) * xsize;
  if (ch.padded == ch.half) {
    copy_rows(dst, dst_stride, src, row_bytes, rows, valid_rows,
              2 * ch.half * xsize, vec16, l);
    return;
  }
  for (int h = 0; h < 2; ++h)
    copy_rows(dst + h * ch.padded * xsize, dst_stride,
              src + (size_t)h * ch.half * xsize, row_bytes, rows, valid_rows,
              ch.valid(c) * xsize, vec16, l);
}

// Which copies of a launch may be 16-byte: bit 0 packed rows (Co % 16 and
// the base), bit 1 scales/zeros rows, bit 2 the X chunks (offsets g*G,
// G/2 and the rows are 16-byte multiples; the wrappers align X's base).
inline int copy_vec(const void* packed, const void* scales, const void* zeros,
                    const void* x, int Co, int ssize, int half, int xsize) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(packed);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(scales) |
                       reinterpret_cast<uintptr_t>(zeros);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  return ((Co % 16 == 0 && pa % 16 == 0) ? 1 : 0) |
         ((Co * ssize % 16 == 0 && sa % 16 == 0) ? 2 : 0) |
         ((half * xsize % 16 == 0 && xa % 16 == 0) ? 4 : 0);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Sum the split partials part[split][E, T, Co] in split order into y,
// times xs[e, t] when given (A8: the activations' scale, applied after the
// groups' sum as the oracle does); rows at or past rows[e] (when given) are
// zeros, their partials unwritten.
template <typename YT>
__global__ void splitk_reduce(const float4* __restrict__ part,
                              const int* __restrict__ rows,
                              const float* __restrict__ xs,
                              YT* __restrict__ y, int T, int Co, size_t n4,
                              int splits) {
  const size_t row4 = Co / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const size_t et = i / row4;
    if (!rows || (int)(et % T) < rows[et / T]) {
      float4 s = part[i];
      for (int k = 1; k < splits; ++k) {
        const float4 p = part[(size_t)k * n4 + i];
        s.x += p.x;
        s.y += p.y;
        s.z += p.z;
        s.w += p.w;
      }
      const float r = xs ? xs[et] : 1.f;     // x * 1 is exact
      v[0] = s.x * r;
      v[1] = s.y * r;
      v[2] = s.z * r;
      v[3] = s.w * r;
    }
    store4(y + 4 * i, v);
  }
}

template <typename YT>
cudaError_t reduce_splits(const float* part, const int* rows,
                          const float* xs, void* y, int E, int T, int Co,
                          int splits, cudaStream_t stream) {
  const size_t n4 = (size_t)E * T * Co / 4;
  const int blocks = (int)std::min<size_t>((n4 + 255) / 256, 4096);
  splitk_reduce<YT><<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), rows, xs, static_cast<YT*>(y),
      T, Co, n4, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace w4tc
