// What the persistent flash kernels share (flash_fwd.cu's K1, flash_bwd.cu's
// K2 and K3): the walk of (head, 128-row tile) items, the 4-D tensor maps of
// the strided [B, H, N, d] views they load by TMA, and the [64][64] bf16
// tiles in TMA's 128-byte swizzle through which a warpgroup's 64 x 64 f32
// accumulators are rounded, staged and stored.
//
// A grid of one block an SM (at most one an item) walks the items in a
// fixed order, item = blockIdx.x + i * gridDim.x with the row tile fast, so
// that a head's items run side by side and read its other tensors from L2,
// and every launch gives the same bits.

#pragma once

#include "flash_mma.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int kRows = 128;              // rows of an item
constexpr uint32_t kBox = 64 * 128;     // [64][64] bf16, swizzled
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of element (r, c) of a [rows][64] bf16 tile that TMA wrote
// with the 128-byte swizzle from a 1024-byte aligned start.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                               (c & 7) * 2);
}

// acc (+)= A B over the 64 rows of a tile of the other side: A from
// registers (bf16 fragments), B the tile read MN-major (16 rows are 2 groups
// of 1024 bytes). An item's first product overwrites acc (first).
__device__ __forceinline__ void out_product(float (&acc)[32],
                                            const uint32_t (&a)[4][4],
                                            uint64_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<64>(acc, a[kk], b + 128 * kk, kk > 0 || !first);
}

// The bf16 A fragments of a 64 x 64 accumulator tile, 16 columns a step.
__device__ __forceinline__ void pack_steps(uint32_t (&f)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
  }
}

// Writes rows 16 (warp % 4) + g and + 8 of a warpgroup's 64 x 64 f32
// accumulators, times mul and rounded to bf16, into the swizzled tile at
// tile (the warpgroup's 64 rows).
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const float (&acc)[32], float mul,
                                           int warp, int g, int t) {
  const int ra = (warp % 4) * 16 + g, rb = ra + 8;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(tile + sw128(ra, c)) =
        __floats2bfloat162_rn(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(tile + sw128(rb, c)) =
        __floats2bfloat162_rn(acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
  }
}

// Stores a warpgroup's 64 staged rows (row 0 is row0 of the head, rows
// from n on are not stored) 16 bytes a thread: d / 8 chunks a row, eight
// threads on a row's consecutive chunks.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sn,
                                           const unsigned char* tile,
                                           int row0, int n, int d, int wt) {
  const int chunks = d / 8;
  for (int i = wt; i < 64 * chunks; i += 128) {
    const int r = i / chunks, c = (i % chunks) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * sn + c) =
          *reinterpret_cast<const uint4*>(tile + sw128(r, c));
  }
}

// What every role of a block derives from the launch's shape.
struct Walk {
  int items;      // (head, row tile) items of the launch
  int row_tiles;  // row tiles of `rows` rows a head
  int tiles;      // 64-row tiles of the other side a head
  __device__ __forceinline__ Walk(int bh, int n, int rows = kRows) {
    row_tiles = (n + rows - 1) / rows;
    items = bh * row_tiles;
    tiles = (n + 63) / 64;
  }
  // the items of this block
  __device__ __forceinline__ int count() const {
    return (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  }
};

// The tensor map of a [B, H, N, d] bf16 view read in boxes of `rows` tokens
// x 64 columns of one head: dims (d, head, token, batch), strides in bytes;
// tokens past N and columns past d read zero.
inline cudaError_t map_view(CUtensorMap* map, const View& t, int batch,
                            int heads, int n, int d, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)t.sh * 2, (cuuint64_t)t.sn * 2,
                                 (cuuint64_t)t.sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return tensor_map_bf16(map, t.p, 4, dims, strides, box);
}

// The persistent grid: one block an SM, at most one an item.
inline cudaError_t persistent_grid(long long items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = (int)(items < sms ? items : sms);
  return err;
}

// Every row of the view starts on a multiple of `bytes` (pointer and
// strides, in elements of 2 bytes).
inline bool rows_aligned(const View& t, int bytes) {
  const long long e = bytes / 2;
  return reinterpret_cast<uintptr_t>(t.p) % bytes == 0 && t.sb % e == 0 &&
         t.sh % e == 0 && t.sn % e == 0;
}

}  // namespace
