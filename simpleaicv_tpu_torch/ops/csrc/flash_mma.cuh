// Device helpers shared by the flash-attention kernels: bf16 tensor-core
// tiles (mma.sync m16n8k16, f32 accumulators), shared-memory fragment loads,
// and the strided [B, H, N, d] tensor view the plain flash kernels take.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16"), with g = lane / 4 and
// t = lane % 4:
//   A 16x16 row-major: a0 = (row g,   cols 2t, 2t+1)   a1 = (row g+8, same)
//                      a2 = (row g,   cols 2t+8, 2t+9) a3 = (row g+8, same)
//   B 16x8:            b0 = (k 2t, 2t+1;   n g)        b1 = (k 2t+8, 2t+9; n g)
//   C 16x8 f32:        c0, c1 = (row g, cols 2t, 2t+1) c2, c3 = (row g+8, same)
// The accumulators of two neighbouring 8-wide C tiles, rounded to bf16, are
// therefore exactly the A fragment of a 16-deep step (acc_to_a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// B fragment for B[k][n] = X[n0 + n][k0 + k], X row-major in shared memory
// with row stride `stride` (the q.k^T pattern: X's rows are the n index).
__device__ __forceinline__ void ld_b_rows(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* x, int stride,
                                          int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = x + (n0 + g) * stride + k0 + 2 * t;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// B fragment for B[k][n] = X[k0 + k][n0 + n], X row-major in shared memory
// (the p.v pattern: X's rows are the k index). ldmatrix.trans hands each
// lane two consecutive rows of one column; rows must be 16-byte aligned.
__device__ __forceinline__ void ld_b_cols(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* x, int stride,
                                          int k0, int n0, int lane) {
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(x + (k0 + (lane & 15)) * stride + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// One [B, H, N, d] tensor with unit stride over d and element strides over
// batch, head and token, so that slices of a fused qkv projection and
// transposed views are read in place.
struct View {
  const void* p;
  long long sb, sh, sn;
};

template <typename T>
__device__ __forceinline__ T* head_ptr(const View& v, int bh, int heads) {
  return const_cast<T*>(static_cast<const T*>(v.p)) +
         (long long)(bh / heads) * v.sb + (long long)(bh % heads) * v.sh;
}

// Copies rows [row0, row0 + ROWS) of one head into a shared tile with row
// stride STR, zero-filling rows >= n and columns >= d.
template <int ROWS, int D_PAD, int STR, int THREADS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long sn, int row0, int n,
                                           int d) {
  for (int idx = threadIdx.x; idx < ROWS * (D_PAD / 2); idx += THREADS) {
    const int r = idx / (D_PAD / 2), c = (idx % (D_PAD / 2)) * 2;
    uint32_t val = 0u;
    if (row0 + r < n && c < d) val = ld_pair(src + (row0 + r) * sn + c);
    *reinterpret_cast<uint32_t*>(&dst[r * STR + c]) = val;
  }
}

// A fragments (16 rows x D_PAD) of rows row_a and row_a + 8 of one head,
// read straight from device memory; rows >= n and columns >= d read zero.
template <int D_PAD>
__device__ __forceinline__ void ld_a_global(uint32_t (&a)[D_PAD / 16][4],
                                            const __nv_bfloat16* src,
                                            long long sn, int row_a, int n,
                                            int d, int t) {
  const bool ok0 = row_a < n, ok1 = row_a + 8 < n;
  const __nv_bfloat16* r0 = src + (long long)row_a * sn;
  const __nv_bfloat16* r1 = src + (long long)(row_a + 8) * sn;
#pragma unroll
  for (int kk = 0; kk < D_PAD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = (ok0 && c < d) ? ld_pair(r0 + c) : 0u;
    a[kk][1] = (ok1 && c < d) ? ld_pair(r1 + c) : 0u;
    a[kk][2] = (ok0 && c + 8 < d) ? ld_pair(r0 + c + 8) : 0u;
    a[kk][3] = (ok1 && c + 8 < d) ? ld_pair(r1 + c + 8) : 0u;
  }
}

}  // namespace
