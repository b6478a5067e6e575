// Flash attention backward with SAM's decomposed relative-position bias, for
// Hopper (sm_90a): two kernels, K5 and K6, that replace the Pallas kernels
// simpleaicv_tpu/ops/flash_attention.py::_relpos_dq_kernel and
// ::_relpos_dkv_kernel.
//
// From q, k, v, dO [BH, N, d], rel_h [BH, N, k_h] f32, rel_w [BH, N, k_w] f32
// (N = k_h * k_w), the forward's row logsumexp lse and delta = rowsum(dO * o)
// (both f32, [BH, N]) they recompute, one key row j of k_w keys at a time,
//   s[i, j*k_w + c] = d^-0.5 * (q_i . k_{j*k_w+c}) + rel_h[i, j] + rel_w[i, c]
//   p  = exp(s - lse)                     (keys past k_w give p = 0)
//   ds = p * (dO v^T - delta)
// and accumulate
//   flash_relpos_dq (K5):  dq = d^-0.5 * ds k     query-major: a block owns
//                          drh[i, j] = sum_c ds   its query rows and walks
//                          drw[i, c] = sum_j ds   the key rows
//   flash_relpos_dkv (K6): dv = p^T dO            key-major: a block owns its
//                          dk = d^-0.5 * ds^T q   keys and walks the queries
// p is rounded to bf16 before p^T dO and ds before the dq and dk products,
// where the JAX backward rounds them; drh and drw are sums of the unrounded
// f32 ds. The [N, N] bias, scores and probabilities never reach device
// memory.
//
// Two kernels, each owning its outputs: no atomics, and the same bits on
// every launch. One key-major kernel could compute all five outputs, but
// drw[i, c] = sum_j ds[i, j*k_w + c] sums over every key row of a head, so
// it would add f32 atomics into a [BH, N, k_w] tensor (100 MB at SAM-B's
// training launch) on top of dq's, and lose the repeatability the checks
// rely on. The price is two more products (7 instead of 5).
//
// Bound: at SAM-B's global layers in training (BH 96 = 12 heads x 8 images,
// N 4096, d 64, bf16) K5 does 3 products, 6*N*N*d*BH = 619 GFLOP, and K6 4,
// 825 GFLOP, over 0.65 and 0.50 GB: bound by tensor-core operations, 0.6254 and
// 0.8338 ms at 989 TFLOP/s. Each score also costs one ex2 on the
// special-function units (16 a cycle an SM), which alone take two thirds as
// long as K5's products and half as long as K6's, and about ten f32
// operations, so the exponentials and the ds arithmetic have to overlap
// the products. The previous design (mma.sync
// on 64-query blocks and 16-key tiles, 4-byte synchronous staging, no
// overlap of loads and products, 4 warps a K6 block) took 15.0395 and
// 16.3554 ms at BH 96 on an H100 at 700 W.
//
// bf16, the path's kernels (relpos_dq_wgmma, relpos_dkv_wgmma), on K4's
// plan (flash_relpos_fwd.cu): a block of two consumer warpgroups of 64 rows
// and a producer warpgroup, which fills a ring of shared-memory stages by
// TMA (128-byte swizzle; tensor maps from cuTensorMapEncodeTiled through the
// runtime's driver entry point) and gives its registers to the consumers
// (setmaxnreg). An mbarrier per stage counts the bytes in and one counts
// the consumer warps out, so no __syncthreads ties the walk; every wait
// traps after 2^32 cycles instead of hanging.
//   - K5: 128 queries of one head a block (grid: query tile fast, then
//     head). Q and dO [128, d] load once; K and V stream through a
//     4-stage ring, one key row (64 keys) a tile. Per tile S = Q K^T and
//     dP = dO V^T (wgmma, both operands from shared memory, K-major), then
//     ds in registers, then dQ += ds K with ds from registers as bf16 (the
//     accumulators of S are the A fragment) and K read MN-major through its
//     descriptor: no transposed copy. rel_w's row (in base 2) and drw stay
//     in registers in the accumulators' own layout for the whole walk;
//     drh[:, j], the row sum of tile j's ds, goes through a [128, 16]
//     shared buffer that each warp flushes for its own 16 rows.
//   - K6: 128 keys (two key rows) of one head a block, the key tile the
//     fast grid index, so that a head's blocks run in one wave and their
//     repeated reads of its Q, dO and rel_w hit L2. K and V load once; the
//     ring brings per 64-query tile Q and dO (8 KB each), rel_w [64, 64]
//     f32 (16 KB: the largest stream, as two swizzled boxes of 32 columns,
//     which the transposed reads below take without bank conflicts), and
//     from a second producer warp (rel_h[i, j] - lse[i]) * log2 e for the
//     block's two key rows and delta, computed on the way in. The tiles are
//     transposed (keys x queries): S^T = K Q^T and dP^T = V dO^T, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers and
//     dO, Q read MN-major.
//   - Overlap: each iteration issues tile u's score products together with
//     tile u - 1's output products and runs tile u's exponentials and ds
//     while the latter are in flight; the two warpgroups take turns to
//     issue (named barriers), so one's arithmetic runs beside the other's
//     products.
//   - Served: bf16 with k_w = 64 (SAM's global layers, N = 64 k_h), d a
//     multiple of 8 up to 64, and q, k, v, dO 16-byte aligned. The only
//     rel-pos shape on a training path is SAM-B's global layer (window
//     layers, N 196, take the einsum path), so other k_w and d > 64 go to
//     the narrow variants rather than to a second, cp.async-fed copy of
//     these consumers: a k_w below 64 puts several key rows in one tile and
//     rel_h's column per score, which these consumers do not model.
// bf16 otherwise (relpos_dq_sync, relpos_dkv_sync, exported as
// flash_relpos_dq_narrow and flash_relpos_dkv_narrow; chosen by
// ops/flash_attention.py): mma.sync m16n8k16 on 64-query blocks and 16-key
// tiles with 4-byte synchronous staging; K6's block is one key row with a
// warp per 16 keys.
// The f32 kernels are plain FMA loops kept for full-precision checks.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a): relpos_dq_wgmma
// and relpos_dkv_wgmma 168 registers at entry (384 threads; setmaxnreg
// then gives each consumer thread 240 and the producer 24), no spills,
// 108,104 and 169,032 bytes of dynamic shared memory, one block an SM; the
// narrow relpos_dq_sync<64> 157 registers, no spills.
//
// Plain C interface, loaded with ctypes; the caller passes contiguous
// tensors and PyTorch's current stream.

#include "flash_mma.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int kBlock = 64;    // queries per dq block, and per dkv tile
constexpr int kKeys = 64;     // most keys in one key row (k_w)
constexpr int kRhCols = 16;   // drh columns buffered in shared memory
constexpr int kSub = 16;      // rows staged per step by the f32 kernels

// Copies `rows` rows of a contiguous [*, d] bf16 tensor, starting at `src`,
// into a shared tile with row stride STR; rows >= valid and columns >= d
// are zero. Called by every thread of the block.
template <int D_PAD, int STR>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int rows,
                                           int valid, int d) {
  for (int idx = threadIdx.x; idx < rows * (D_PAD / 2); idx += blockDim.x) {
    const int r = idx / (D_PAD / 2), c = (idx % (D_PAD / 2)) * 2;
    uint32_t val = 0u;
    if (r < valid && c < d) val = ld_pair(src + (size_t)r * d + c);
    *reinterpret_cast<uint32_t*>(&dst[r * STR + c]) = val;
  }
}

// Writes columns [col0, col0 + cnt) of the block's 64 buffered drh rows.
__device__ __forceinline__ void flush_drh(float* __restrict__ drh,
                                          float (*buf)[kRhCols + 1],
                                          size_t head_row0, int rows_left,
                                          int k_h, int col0, int cnt) {
  for (int idx = threadIdx.x; idx < kBlock * kRhCols; idx += blockDim.x) {
    const int r = idx / kRhCols, c = idx % kRhCols;
    if (c < cnt && r < rows_left)
      drh[(head_row0 + r) * k_h + col0 + c] = buf[r][c];
  }
}

// ----------------- bf16, mma.sync (the narrow variants) -------------------

// dq, drh, drw in bf16. Block: 64 queries, 4 warps of 16 query rows; lane
// (g, t) owns rows g and g+8 of its warp and, in every 8-wide key tile,
// columns 2t and 2t+1. The key row is zero-padded to a multiple of 16 keys
// and d to D_PAD.
template <int D_PAD>
__global__ void __launch_bounds__(128)
relpos_dq_sync(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ rel_h,
               const float* __restrict__ rel_w, const float* __restrict__ lse,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
               float* __restrict__ drh, float* __restrict__ drw, int n, int d,
               int k_h, int k_w, float scale) {
  constexpr int STR = D_PAD + 8;
  constexpr int DK = D_PAD / 16;
  constexpr int DT = D_PAD / 8;
  constexpr int NT = kKeys / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys * STR];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys * STR];
  __shared__ float rh_buf[kBlock][kRhCols + 1];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int block_row0 = blockIdx.x * kBlock;
  const int row0 = block_row0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const size_t base = (size_t)bh * n * d;
  const size_t head_row = (size_t)bh * n;
  const int kw_pad = (k_w + 15) / 16 * 16;

  uint32_t qf[DK][4], dof[DK][4];
  ld_a_global<D_PAD>(qf, q + base, d, row0, n, d, t);
  ld_a_global<D_PAD>(dof, dout + base, d, row0, n, d, t);
  const float lse0 = ok0 ? lse[head_row + row0] : 0.f;
  const float lse1 = ok1 ? lse[head_row + row1] : 0.f;
  const float dl0 = ok0 ? delta[head_row + row0] : 0.f;
  const float dl1 = ok1 ? delta[head_row + row1] : 0.f;
  const float* rh0 = rel_h + (head_row + (ok0 ? row0 : 0)) * k_h;
  const float* rh1 = rel_h + (head_row + (ok1 ? row1 : 0)) * k_h;
  const float* rw0 = rel_w + (head_row + (ok0 ? row0 : 0)) * k_w;
  const float* rw1 = rel_w + (head_row + (ok1 ? row1 : 0)) * k_w;

  float acc[DT][4], drw_acc[NT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    drw_acc[nt][0] = drw_acc[nt][1] = drw_acc[nt][2] = drw_acc[nt][3] = 0.f;

  for (int j = 0; j < k_h; ++j) {
    __syncthreads();  // the previous row's tiles and drh column are done
    if (j > 0 && j % kRhCols == 0)
      flush_drh(drh, rh_buf, head_row + block_row0, n - block_row0, k_h,
                j - kRhCols, kRhCols);
    const size_t key0 = base + (size_t)j * k_w * d;
    stage_rows<D_PAD, STR>(ks, k + key0, kw_pad, k_w, d);
    stage_rows<D_PAD, STR>(vs, v + key0, kw_pad, k_w, d);
    __syncthreads();

    const float bias0 = ok0 ? __ldg(rh0 + j) : 0.f;
    const float bias1 = ok1 ? __ldg(rh1 + j) : 0.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      if (kk * 16 < k_w) {  // else the rest of the tile is padding
        float s[2][4], dp[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
          dp[h][0] = dp[h][1] = dp[h][2] = dp[h][3] = 0.f;
#pragma unroll
          for (int c = 0; c < DK; ++c) {
            uint32_t b0, b1;
            ld_b_rows(b0, b1, ks, STR, kk * 16 + h * 8, c * 16, g, t);
            mma_bf16(s[h], qf[c], b0, b1);
            ld_b_rows(b0, b1, vs, STR, kk * 16 + h * 8, c * 16, g, t);
            mma_bf16(dp[h], dof[c], b0, b1);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kk * 16 + h * 8 + 2 * t + e;
            const bool valid = col < k_w;
            const float w0 = (valid && ok0) ? __ldg(rw0 + col) : 0.f;
            const float w1 = (valid && ok1) ? __ldg(rw1 + col) : 0.f;
            const float p0 =
                valid ? expf(s[h][e] * scale + bias0 + w0 - lse0) : 0.f;
            const float p1 =
                valid ? expf(s[h][2 + e] * scale + bias1 + w1 - lse1) : 0.f;
            const float ds0 = p0 * (dp[h][e] - dl0);
            const float ds1 = p1 * (dp[h][2 + e] - dl1);
            s[h][e] = ds0;  // ds, in place of s
            s[h][2 + e] = ds1;
            sum0 += ds0;
            sum1 += ds1;
            drw_acc[kk * 2 + h][e] += ds0;
            drw_acc[kk * 2 + h][2 + e] += ds1;
          }
        }
        uint32_t a[4];
        acc_to_a(a, s[0], s[1]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t b0, b1;
          ld_b_cols(b0, b1, ks, STR, kk * 16, dt * 8, lane);
          mma_bf16(acc[dt], a, b0, b1);
        }
      }
    }
    // the four lanes of a quad hold one row between them
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    if (t == 0) {
      rh_buf[warp * 16 + g][j % kRhCols] = sum0;
      rh_buf[warp * 16 + g + 8][j % kRhCols] = sum1;
    }
  }
  __syncthreads();
  const int last0 = (k_h - 1) / kRhCols * kRhCols;
  flush_drh(drh, rh_buf, head_row + block_row0, n - block_row0, k_h, last0,
            k_h - last0);

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c < d) {
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * d + c) =
            __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * d + c) =
            __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * t + e;
      if (col < k_w) {
        if (ok0) drw[(head_row + row0) * k_w + col] = drw_acc[nt][e];
        if (ok1) drw[(head_row + row1) * k_w + col] = drw_acc[nt][2 + e];
      }
    }
  }
}

// dk, dv in bf16. Block: key row j, one warp per 16 of its keys (blockDim.x
// = 32 * ceil(k_w / 16)); lane (g, t) owns keys g and g+8 of its warp.
// Tiles are transposed: rows are keys, columns queries. Padded query columns
// carry lse = +inf, so their p and ds are exactly 0.
template <int D_PAD>
__global__ void __launch_bounds__(128)
relpos_dkv_sync(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ rel_h,
                const float* __restrict__ rel_w,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int n, int d, int k_h, int k_w, float scale) {
  constexpr int STR = D_PAD + 8;
  constexpr int DK = D_PAD / 16;
  constexpr int DT = D_PAD / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kBlock * STR];
  __shared__ __align__(16) __nv_bfloat16 dos[kBlock * STR];
  __shared__ float ls[kBlock];
  __shared__ float dls[kBlock];
  __shared__ float rhs[kBlock];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int j = blockIdx.x, bh = blockIdx.y;
  const int c0 = warp * 16 + g, c1 = c0 + 8;  // keys within the row
  const bool ok0 = c0 < k_w, ok1 = c1 < k_w;
  const size_t base = (size_t)bh * n * d;
  const size_t head_row = (size_t)bh * n;
  const size_t key0 = base + (size_t)j * k_w * d;

  uint32_t kf[DK][4], vf[DK][4];
  ld_a_global<D_PAD>(kf, k + key0, d, c0, k_w, d, t);
  ld_a_global<D_PAD>(vf, v + key0, d, c0, k_w, d, t);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kBlock) {
    __syncthreads();
    stage_rows<D_PAD, STR>(qs, q + base + (size_t)q0 * d, kBlock, n - q0, d);
    stage_rows<D_PAD, STR>(dos, dout + base + (size_t)q0 * d, kBlock, n - q0,
                           d);
    for (int r = threadIdx.x; r < kBlock; r += blockDim.x) {
      const bool in = q0 + r < n;
      ls[r] = in ? lse[head_row + q0 + r] : INFINITY;
      dls[r] = in ? delta[head_row + q0 + r] : 0.f;
      rhs[r] = in ? __ldg(rel_h + (head_row + q0 + r) * k_h + j) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      if (q0 + kk * 16 < n) {  // else the rest of the tile is padding
        float p[2][4], ds[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          p[h][0] = p[h][1] = p[h][2] = p[h][3] = 0.f;
          ds[h][0] = ds[h][1] = ds[h][2] = ds[h][3] = 0.f;
#pragma unroll
          for (int c = 0; c < DK; ++c) {
            uint32_t b0, b1;
            ld_b_rows(b0, b1, qs, STR, kk * 16 + h * 8, c * 16, g, t);
            mma_bf16(p[h], kf[c], b0, b1);  // s^T
            ld_b_rows(b0, b1, dos, STR, kk * 16 + h * 8, c * 16, g, t);
            mma_bf16(ds[h], vf[c], b0, b1);  // dp^T
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = kk * 16 + h * 8 + 2 * t + e;
            const bool in = q0 + col < n;
            const float* rw = rel_w + (head_row + (in ? q0 + col : 0)) * k_w;
            const float w0 = (in && ok0) ? __ldg(rw + c0) : 0.f;
            const float w1 = (in && ok1) ? __ldg(rw + c1) : 0.f;
            const float l = ls[col], dl = dls[col], bias = rhs[col];
            p[h][e] = ok0 ? expf(p[h][e] * scale + bias + w0 - l) : 0.f;
            p[h][2 + e] =
                ok1 ? expf(p[h][2 + e] * scale + bias + w1 - l) : 0.f;
            ds[h][e] = p[h][e] * (ds[h][e] - dl);
            ds[h][2 + e] = p[h][2 + e] * (ds[h][2 + e] - dl);
          }
        }
        uint32_t ap[4], ads[4];
        acc_to_a(ap, p[0], p[1]);
        acc_to_a(ads, ds[0], ds[1]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t b0, b1;
          ld_b_cols(b0, b1, dos, STR, kk * 16, dt * 8, lane);
          mma_bf16(dva[dt], ap, b0, b1);
          ld_b_cols(b0, b1, qs, STR, kk * 16, dt * 8, lane);
          mma_bf16(dka[dt], ads, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c < d) {
      if (ok0) {
        *reinterpret_cast<__nv_bfloat162*>(dk + key0 + (size_t)c0 * d + c) =
            __floats2bfloat162_rn(dka[dt][0] * scale, dka[dt][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + key0 + (size_t)c0 * d + c) =
            __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
      }
      if (ok1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + key0 + (size_t)c1 * d + c) =
            __floats2bfloat162_rn(dka[dt][2] * scale, dka[dt][3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + key0 + (size_t)c1 * d + c) =
            __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
      }
    }
  }
}

// ---------------------------------- f32 ----------------------------------

// Stages rows [0, cnt) of two contiguous [*, d] f32 tensors, the first
// multiplied by `mul`; the other rows and columns >= d are zero.
template <int D_PAD>
__device__ __forceinline__ void stage_f32(float (*a)[D_PAD], float (*b)[D_PAD],
                                          const float* ap, const float* bp,
                                          float mul, int cnt, int d) {
  for (int idx = threadIdx.x; idx < kSub * D_PAD; idx += kBlock) {
    const int r = idx / D_PAD, c = idx % D_PAD;
    const bool in = r < cnt && c < d;
    a[r][c] = in ? ap[(size_t)r * d + c] * mul : 0.f;
    b[r][c] = in ? bp[(size_t)r * d + c] : 0.f;
  }
}

// f32 dq, drh, drw: one thread per query row; keys staged 16 at a time. The
// thread owns its rows of drh and drw and sums drw in device memory.
template <int D_PAD>
__global__ void __launch_bounds__(kBlock)
relpos_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ rel_h, const float* __restrict__ rel_w,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ drh,
              float* __restrict__ drw, int n, int d, int k_h, int k_w,
              float scale) {
  __shared__ float ks[kSub][D_PAD];
  __shared__ float vs[kSub][D_PAD];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlock + threadIdx.x;
  const bool ok = row < n;
  const size_t base = (size_t)bh * n * d;
  const size_t hr = (size_t)bh * n + (ok ? row : 0);

  float qr[D_PAD], dor[D_PAD], acc[D_PAD];
#pragma unroll
  for (int i = 0; i < D_PAD; ++i) {
    qr[i] = (ok && i < d) ? q[base + (size_t)row * d + i] * scale : 0.f;
    dor[i] = (ok && i < d) ? dout[base + (size_t)row * d + i] : 0.f;
    acc[i] = 0.f;
  }
  const float l = ok ? lse[hr] : 0.f;
  const float dl = ok ? delta[hr] : 0.f;
  const float* rh = rel_h + hr * k_h;
  const float* rw = rel_w + hr * k_w;
  float* drh_row = drh + hr * k_h;
  float* drw_row = drw + hr * k_w;

  for (int j = 0; j < k_h; ++j) {
    const float bias_h = ok ? rh[j] : 0.f;
    float row_sum = 0.f;
    for (int c0 = 0; c0 < k_w; c0 += kSub) {
      const int cnt = min(kSub, k_w - c0);
      const size_t key0 = base + (size_t)(j * k_w + c0) * d;
      __syncthreads();
      stage_f32<D_PAD>(ks, vs, k + key0, v + key0, 1.f, cnt, d);
      __syncthreads();
      for (int r = 0; r < cnt; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < D_PAD; ++i) {
          s = fmaf(qr[i], ks[r][i], s);
          dp = fmaf(dor[i], vs[r][i], dp);
        }
        if (ok) {
          const float ds = expf(s + bias_h + rw[c0 + r] - l) * (dp - dl);
#pragma unroll
          for (int i = 0; i < D_PAD; ++i) acc[i] = fmaf(ds, ks[r][i], acc[i]);
          row_sum += ds;
          drw_row[c0 + r] = (j == 0 ? 0.f : drw_row[c0 + r]) + ds;
        }
      }
    }
    if (ok) drh_row[j] = row_sum;
  }
  if (ok) {
#pragma unroll
    for (int i = 0; i < D_PAD; ++i)
      if (i < d) dq[base + (size_t)row * d + i] = acc[i] * scale;
  }
}

// f32 dk, dv: block per key row, one thread per key; queries (scaled by
// d^-0.5, so dk carries the scale) and dO staged 16 at a time.
template <int D_PAD>
__global__ void __launch_bounds__(kBlock)
relpos_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ rel_h,
               const float* __restrict__ rel_w, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int n, int d, int k_h, int k_w,
               float scale) {
  __shared__ float qs[kSub][D_PAD];
  __shared__ float dos[kSub][D_PAD];
  __shared__ float ls[kSub];
  __shared__ float dls[kSub];
  __shared__ float rhs[kSub];
  const int j = blockIdx.x, bh = blockIdx.y;
  const int c = threadIdx.x;
  const bool ok = c < k_w;
  const size_t base = (size_t)bh * n * d;
  const size_t head_row = (size_t)bh * n;
  const size_t key = base + (size_t)(j * k_w + (ok ? c : 0)) * d;

  float kr[D_PAD], vr[D_PAD], dkr[D_PAD], dvr[D_PAD];
#pragma unroll
  for (int i = 0; i < D_PAD; ++i) {
    kr[i] = (ok && i < d) ? k[key + i] : 0.f;
    vr[i] = (ok && i < d) ? v[key + i] : 0.f;
    dkr[i] = dvr[i] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kSub) {
    const int cnt = min(kSub, n - q0);
    __syncthreads();
    stage_f32<D_PAD>(qs, dos, q + base + (size_t)q0 * d,
                     dout + base + (size_t)q0 * d, scale, cnt, d);
    if (threadIdx.x < cnt) {
      ls[threadIdx.x] = lse[head_row + q0 + threadIdx.x];
      dls[threadIdx.x] = delta[head_row + q0 + threadIdx.x];
      rhs[threadIdx.x] = rel_h[(head_row + q0 + threadIdx.x) * k_h + j];
    }
    __syncthreads();
    if (ok) {
      for (int r = 0; r < cnt; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < D_PAD; ++i) {
          s = fmaf(kr[i], qs[r][i], s);
          dp = fmaf(vr[i], dos[r][i], dp);
        }
        const float w = rel_w[(head_row + q0 + r) * k_w + c];
        const float p = expf(s + rhs[r] + w - ls[r]);
        const float ds = p * (dp - dls[r]);
#pragma unroll
        for (int i = 0; i < D_PAD; ++i) {
          dvr[i] = fmaf(p, dos[r][i], dvr[i]);
          dkr[i] = fmaf(ds, qs[r][i], dkr[i]);
        }
      }
    }
  }
  if (ok) {
#pragma unroll
    for (int i = 0; i < D_PAD; ++i)
      if (i < d) {
        dk[key + i] = dkr[i];
        dv[key + i] = dvr[i];
      }
  }
}

// ------------------- bf16, wgmma + TMA (the path's kernels) -----------------

constexpr int kTile = 128;                    // queries (K5) or keys (K6)
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kWsThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kStages = 4;                    // stages in the TMA ring
constexpr uint32_t kBox = 64 * 128;  // [64][64] bf16 or [64][32] f32, swizzled
constexpr int kRhStr = kRhCols + 1;  // row stride of K5's drh buffer
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K5's dynamic shared memory: 1024 bytes to align the swizzled tiles, Q and
// dO [128][64], the ring of K/V tiles, the drh buffer and the mbarriers.
constexpr int kDqSmem = 1024 + 4 * kBox + kStages * 2 * kBox +
                        kTile * kRhStr * 4 + (2 * kStages + 1) * 8;

// dq, drh, drw for 128 queries of head blockIdx.y. Warpgroup wg owns query
// rows 64 wg .. 64 wg + 63; in the accumulators of a 64x64 product, warp w
// of it holds rows 16w + g and 16w + g + 8 (a and b below), and
// accumulator i is column 8 (i / 4) + 2t + i % 2 of row a (i % 4 < 2) or b.
__global__ void __launch_bounds__(kWsThreads, 1)
relpos_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const float* __restrict__ rel_h,
                const float* __restrict__ rel_w,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, float* __restrict__ drh,
                float* __restrict__ drw, int n, int d, int k_h, float scale,
                float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t qs = (s0 + 1023) & ~1023u;
  const uint32_t dos = qs + 2 * kBox;
  const uint32_t ring = dos + 2 * kBox;  // stage s: K, then V
  const uint32_t rhb_s = ring + kStages * 2 * kBox;
  // full[s]: TMA's bytes; empty[s]: the 8 consumer warps, once their
  // products have read the stage; qbar: Q and dO
  const uint32_t full = rhb_s + kTile * kRhStr * 4;
  const uint32_t empty = full + kStages * 8;
  const uint32_t qbar = empty + kStages * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t head_row = (size_t)bh * n;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init(qbar, 1);
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer: one thread loads Q and dO, then key row u into stage
    // u % kStages once both warpgroups have released the row it held
    setmaxnreg_dec<24>();
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_arrive_expect_tx(qbar, 4 * kBox);
      tma_load_2d(qs, &q_map, 0, (int)head_row + q0, qbar);
      tma_load_2d(dos, &do_map, 0, (int)head_row + q0, qbar);
      for (int u = 0; u < k_h; ++u) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(empty + 8 * s, (u / kStages - 1) & 1);
        const uint32_t ks = ring + s * 2 * kBox;
        mbar_arrive_expect_tx(full + 8 * s, 2 * kBox);
        tma_load_2d(ks, &k_map, 0, (int)head_row + u * 64, full + 8 * s);
        tma_load_2d(ks + kBox, &v_map, 0, (int)head_row + u * 64,
                    full + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int wrow0 = wg * 64 + (warp % 4) * 16;  // the warp's first row
  const int row_a = q0 + wrow0 + g, row_b = row_a + 8;
  const bool ok_a = row_a < n, ok_b = row_b < n;
  const size_t ga = head_row + (ok_a ? row_a : 0);
  const size_t gb = head_row + (ok_b ? row_b : 0);
  // -lse in base 2, -inf for rows past N (their p is 0), and delta
  const float nl_a = ok_a ? -lse[ga] * kLog2e : -INFINITY;
  const float nl_b = ok_b ? -lse[gb] * kLog2e : -INFINITY;
  const float dl_a = ok_a ? delta[ga] : 0.f;
  const float dl_b = ok_b ? delta[gb] : 0.f;
  // rel_w in base 2, the drw sums, and dq, in the accumulators' layout
  float rw[32], drw_acc[32], dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i / 4) + 2 * t + (i % 2);
    rw[i] = __ldg(rel_w + ((i % 4) < 2 ? ga : gb) * 64 + c) * kLog2e;
    drw_acc[i] = dq_acc[i] = 0.f;
  }
  const float* rh_a = rel_h + ga * k_h;
  const float* rh_b = rel_h + gb * k_h;
  float rh_next_a = __ldg(rh_a), rh_next_b = __ldg(rh_b);
  float* rhb = reinterpret_cast<float*>(smem + (rhb_s - s0)) +
               wrow0 * kRhStr;  // the warp's 16 rows

  mbar_wait(qbar, 0);
  const uint64_t desc_q = wgmma_desc_sw128(qs + wg * kBox);
  const uint64_t desc_do = wgmma_desc_sw128(dos + wg * kBox);
  uint32_t dsf[4][4];  // the previous tile's ds, bf16 A fragments

  // Each iteration issues S = Q K_u^T and dP = dO V_u^T, then
  // dQ += ds_{u-1} K_{u-1}, and computes ds_u while the last is in flight.
  // The two warpgroups take turns to issue (named barriers 1 and 2,
  // warpgroup 0 first).
  if (wg == 1) named_bar_arrive(1, kConsumers);
  for (int u = 0; u <= k_h; ++u) {
    const int s = u % kStages, prev = (u + kStages - 1) % kStages;
    float sacc[32], pacc[32];
    if (u < k_h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
      mbar_wait(full + 8 * s, (u / kStages) & 1);
    }
    named_bar_sync(1 + wg, kConsumers);
    wgmma_fence();
    if (u < k_h) {
      const uint64_t desc_k = wgmma_desc_sw128(ring + s * 2 * kBox);
      const uint64_t desc_v = wgmma_desc_sw128(ring + s * 2 * kBox + kBox);
      // 16 columns of d: 32 bytes into each swizzled row
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(sacc, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(pacc, desc_do + 2 * kk, desc_v + 2 * kk, kk > 0);
    }
    wgmma_commit();
    if (u > 0) {
      // K read MN-major: 16 keys are 2 groups of 1024 bytes
      const uint64_t desc_k = wgmma_desc_sw128(ring + prev * 2 * kBox);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(dq_acc, dsf[kk], desc_k + 128 * kk);
    }
    wgmma_commit();
    if (wg == 0 || u < k_h) named_bar_arrive(2 - wg, kConsumers);
    if (u == k_h) {
      wgmma_wait<0>();
      fence_operands(dq_acc);
      break;
    }
    const float rb_a = fmaf(rh_next_a, kLog2e, nl_a);
    const float rb_b = fmaf(rh_next_b, kLog2e, nl_b);
    if (u + 1 < k_h) {
      rh_next_a = __ldg(rh_a + u + 1);
      rh_next_b = __ldg(rh_b + u + 1);
    }
    wgmma_wait<1>();  // S and dP are ready; dQ may still run
    fence_operands(sacc);
    fence_operands(pacc);

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool a = (i % 4) < 2;
      const float p =
          exp2_approx(fmaf(sacc[i], scale_log2, rw[i]) + (a ? rb_a : rb_b));
      const float ds = p * (pacc[i] - (a ? dl_a : dl_b));
      sacc[i] = ds;
      drw_acc[i] += ds;
      if (a)
        sum_a += ds;
      else
        sum_b += ds;
    }
    wgmma_wait<0>();  // dQ += ds_{u-1} K_{u-1} is done: the stage is free
    fence_operands(dq_acc);
    if (u > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsf[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
    }

    // drh[:, u]: the quad's lanes hold a row between them
    sum_a = quad_sum(sum_a);
    sum_b = quad_sum(sum_b);
    const int col = u % kRhCols;
    if (t == 0) {
      rhb[g * kRhStr + col] = sum_a;
      rhb[(g + 8) * kRhStr + col] = sum_b;
    }
    if (col == kRhCols - 1 || u == k_h - 1) {
      __syncwarp();
      for (int i = lane; i < 16 * kRhCols; i += 32) {
        const int r = i / kRhCols, c = i % kRhCols;
        const int row = q0 + wrow0 + r;
        if (c <= col && row < n)
          drh[(head_row + row) * k_h + (u - col) + c] = rhb[r * kRhStr + c];
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (ok_a) {
      *reinterpret_cast<float2*>(drw + (head_row + row_a) * 64 + c) =
          make_float2(drw_acc[4 * jj], drw_acc[4 * jj + 1]);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(dq + (head_row + row_a) * d + c) =
            __floats2bfloat162_rn(dq_acc[4 * jj] * scale,
                                  dq_acc[4 * jj + 1] * scale);
    }
    if (ok_b) {
      *reinterpret_cast<float2*>(drw + (head_row + row_b) * 64 + c) =
          make_float2(drw_acc[4 * jj + 2], drw_acc[4 * jj + 3]);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(dq + (head_row + row_b) * d + c) =
            __floats2bfloat162_rn(dq_acc[4 * jj + 2] * scale,
                                  dq_acc[4 * jj + 3] * scale);
    }
  }
}

// K6's ring stage: Q and dO [64][64] bf16, rel_w [64][64] f32 as two boxes
// of 32 columns, and three [64] f32 columns (rel_h - lse in base 2 for each
// of the block's key rows, and delta) padded to 1024 bytes.
constexpr uint32_t kDkvStage = 4 * kBox + 1024;
constexpr int kDkvSmem = 1024 + 4 * kBox + kStages * kDkvStage +
                         (2 * kStages + 1) * 8;

// dk, dv for 128 keys (key rows 2 blockIdx.x and 2 blockIdx.x + 1) of head
// blockIdx.y. Warpgroup wg owns key row j0 + wg; the tiles are transposed,
// so warp w holds keys 16w + g and 16w + g + 8 of the row (a and b) and
// accumulator i is query column 8 (i / 4) + 2t + i % 2 of the tile.
__global__ void __launch_bounds__(kWsThreads, 1)
relpos_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap rw_map,
                 const float* __restrict__ rel_h,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int n, int d, int k_h,
                 float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t ks = (s0 + 1023) & ~1023u;
  const uint32_t vs = ks + 2 * kBox;
  const uint32_t ring = vs + 2 * kBox;  // stage: Q, dO, rel_w, columns
  // full[s]: TMA's bytes and the 32 lanes of the column warp; empty[s]: the
  // 8 consumer warps; kvbar: K and V
  const uint32_t full = ring + kStages * kDkvStage;
  const uint32_t empty = full + kStages * 8;
  const uint32_t kvbar = empty + kStages * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, j0 = 2 * blockIdx.x;
  const size_t head_row = (size_t)bh * n;
  const int tiles = n / 64;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init(kvbar, 1);
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer: one thread loads K and V, then the TMA tiles of query
    // tile u into stage u % kStages once both warpgroups have released it;
    // the next warp computes the stage's columns
    setmaxnreg_dec<24>();
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_arrive_expect_tx(kvbar, 4 * kBox);
      tma_load_2d(ks, &k_map, 0, (int)head_row + j0 * 64, kvbar);
      tma_load_2d(vs, &v_map, 0, (int)head_row + j0 * 64, kvbar);
      for (int u = 0; u < tiles; ++u) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(empty + 8 * s, (u / kStages - 1) & 1);
        const uint32_t st = ring + s * kDkvStage;
        const int row = (int)head_row + u * 64;
        mbar_arrive_expect_tx(full + 8 * s, 4 * kBox);
        tma_load_2d(st, &q_map, 0, row, full + 8 * s);
        tma_load_2d(st + kBox, &do_map, 0, row, full + 8 * s);
        tma_load_2d(st + 2 * kBox, &rw_map, 0, row, full + 8 * s);
        tma_load_2d(st + 3 * kBox, &rw_map, 32, row, full + 8 * s);
      }
    } else if (warp == kConsumers / 32 + 1) {
      for (int u = 0; u < tiles; ++u) {
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(empty + 8 * s, (u / kStages - 1) & 1);
        float* cols = reinterpret_cast<float*>(
            smem + (ring + s * kDkvStage + 4 * kBox - s0));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = lane + 32 * h;
          const size_t r = head_row + u * 64 + q;
          const float nl = -lse[r];
          cols[q] = (rel_h[r * k_h + j0] + nl) * kLog2e;
          cols[64 + q] =
              j0 + 1 < k_h ? (rel_h[r * k_h + j0 + 1] + nl) * kLog2e
                           : -INFINITY;
          cols[128 + q] = delta[r];
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int j = j0 + wg;                         // the warpgroup's key row
  const int c_a = (warp % 4) * 16 + g, c_b = c_a + 8;  // its keys
  // rel_w's column c_a or c_b of query q lies in box c / 32, at byte
  // q * 128 + (((c % 32) / 4 ^ q % 8) * 16) + (c % 4) * 4 of it
  const uint32_t rw_off = (c_a / 32) * kBox;
  const int ch_a = (c_a % 32) / 4, ch_b = (c_b % 32) / 4;
  const int in_chunk = (c_a % 4) * 4;  // c_b % 4 is the same
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  uint32_t pf[4][4], dsf[4][4];  // the previous tile's P^T and dS^T, bf16

  mbar_wait(kvbar, 0);
  const uint64_t desc_k = wgmma_desc_sw128(ks + wg * kBox);
  const uint64_t desc_v = wgmma_desc_sw128(vs + wg * kBox);

  // Each iteration issues S^T = K Q_u^T and dP^T = V dO_u^T, then
  // dV += P^T_{u-1} dO_{u-1} and dK += dS^T_{u-1} Q_{u-1}, and computes
  // tile u's P^T and dS^T while the latter are in flight; the warpgroups
  // take turns to issue, as in K5.
  if (wg == 1) named_bar_arrive(1, kConsumers);
  for (int u = 0; u <= tiles; ++u) {
    const int s = u % kStages, prev = (u + kStages - 1) % kStages;
    const uint32_t st = ring + s * kDkvStage;
    float sacc[32], pacc[32];
    if (u < tiles) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;
      mbar_wait(full + 8 * s, (u / kStages) & 1);
    }
    named_bar_sync(1 + wg, kConsumers);
    wgmma_fence();
    if (u < tiles) {
      const uint64_t desc_q = wgmma_desc_sw128(st);
      const uint64_t desc_do = wgmma_desc_sw128(st + kBox);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(sacc, desc_k + 2 * kk, desc_q + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(pacc, desc_v + 2 * kk, desc_do + 2 * kk, kk > 0);
    }
    wgmma_commit();
    if (u > 0) {
      // dO and Q read MN-major: 16 queries are 2 groups of 1024 bytes
      const uint32_t sp = ring + prev * kDkvStage;
      const uint64_t desc_q = wgmma_desc_sw128(sp);
      const uint64_t desc_do = wgmma_desc_sw128(sp + kBox);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(dv_acc, pf[kk], desc_do + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(dk_acc, dsf[kk], desc_q + 128 * kk);
    }
    wgmma_commit();
    if (wg == 0 || u < tiles) named_bar_arrive(2 - wg, kConsumers);
    if (u == tiles) {
      wgmma_wait<0>();
      fence_operands(dk_acc);
      fence_operands(dv_acc);
      break;
    }
    const float* cols =
        reinterpret_cast<const float*>(smem + (st + 4 * kBox - s0));
    const unsigned char* rwt = smem + (st + 2 * kBox + rw_off - s0);
    wgmma_wait<1>();  // S^T and dP^T are ready; dV and dK may still run
    fence_operands(sacc);
    fence_operands(pacc);

#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int qc = 8 * jj + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(cols + 64 * wg + qc);
      const float2 dl = *reinterpret_cast<const float2*>(cols + 128 + qc);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = qc + e;
        const unsigned char* row = rwt + q * 128 + in_chunk;
        const float w_a =
            *reinterpret_cast<const float*>(row + ((ch_a ^ (q & 7)) << 4));
        const float w_b =
            *reinterpret_cast<const float*>(row + ((ch_b ^ (q & 7)) << 4));
        const float b = e ? bias.y : bias.x, dlt = e ? dl.y : dl.x;
        const int ia = 4 * jj + e, ib = ia + 2;
        float p = exp2_approx(fmaf(sacc[ia], scale_log2, fmaf(w_a, kLog2e, b)));
        pacc[ia] = p * (pacc[ia] - dlt);
        sacc[ia] = p;
        p = exp2_approx(fmaf(sacc[ib], scale_log2, fmaf(w_b, kLog2e, b)));
        pacc[ib] = p * (pacc[ib] - dlt);
        sacc[ib] = p;
      }
    }
    wgmma_wait<0>();  // tile u - 1's dV and dK are done: its stage is free
    fence_operands(dk_acc);
    fence_operands(dv_acc);
    if (u > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pf[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
        dsf[kk][e] = pack_bf16(pacc[8 * kk + 2 * e], pacc[8 * kk + 2 * e + 1]);
      }
    }
  }

  if (j >= k_h) return;  // the second key row of an odd k_h's last block
  const size_t key_a = head_row + (size_t)j * 64 + c_a, key_b = key_a + 8;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    if (c < d) {
      *reinterpret_cast<__nv_bfloat162*>(dk + key_a * d + c) =
          __floats2bfloat162_rn(dk_acc[4 * jj] * scale,
                                dk_acc[4 * jj + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + key_a * d + c) =
          __floats2bfloat162_rn(dv_acc[4 * jj], dv_acc[4 * jj + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + key_b * d + c) =
          __floats2bfloat162_rn(dk_acc[4 * jj + 2] * scale,
                                dk_acc[4 * jj + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + key_b * d + c) =
          __floats2bfloat162_rn(dv_acc[4 * jj + 2], dv_acc[4 * jj + 3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *rel_h, *rel_w, *lse, *delta;
  int n, d, k_h, k_w;
  float scale;
};

template <int D_PAD>
void launch_dq(bool bf16, dim3 grid, cudaStream_t st, const Args& a, void* dq,
               float* drh, float* drw) {
  if (bf16)
    relpos_dq_sync<D_PAD><<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout), a.rel_h, a.rel_w, a.lse,
        a.delta, static_cast<__nv_bfloat16*>(dq), drh, drw, a.n, a.d, a.k_h,
        a.k_w, a.scale);
  else
    relpos_dq_f32<D_PAD><<<grid, kBlock, 0, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.rel_h, a.rel_w, a.lse, a.delta, static_cast<float*>(dq), drh, drw,
        a.n, a.d, a.k_h, a.k_w, a.scale);
}

template <int D_PAD>
void launch_dkv(bool bf16, dim3 grid, cudaStream_t st, const Args& a, void* dk,
                void* dv) {
  if (bf16)
    relpos_dkv_sync<D_PAD><<<grid, 32 * ((a.k_w + 15) / 16), 0, st>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.dout), a.rel_h, a.rel_w, a.lse,
        a.delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), a.n, a.d, a.k_h, a.k_w, a.scale);
  else
    relpos_dkv_f32<D_PAD><<<grid, kBlock, 0, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.rel_h, a.rel_w, a.lse, a.delta, static_cast<float*>(dk),
        static_cast<float*>(dv), a.n, a.d, a.k_h, a.k_w, a.scale);
}

// The narrow (bf16) or f32 kernels.
void launch_sync_or_f32(bool dq_side, bool bf16, int bh, cudaStream_t st,
                        const Args& a, void* o0, void* o1, void* o2) {
  const dim3 grid = dq_side ? dim3((a.n + kBlock - 1) / kBlock, bh)
                            : dim3(a.k_h, bh);
  float* f1 = static_cast<float*>(o1);
  float* f2 = static_cast<float*>(o2);
  if (dq_side) {
    if (a.d <= 64)
      launch_dq<64>(bf16, grid, st, a, o0, f1, f2);
    else if (a.d <= 80)
      launch_dq<80>(bf16, grid, st, a, o0, f1, f2);
    else
      launch_dq<128>(bf16, grid, st, a, o0, f1, f2);
  } else {
    if (a.d <= 64)
      launch_dkv<64>(bf16, grid, st, a, o0, o1);
    else if (a.d <= 80)
      launch_dkv<80>(bf16, grid, st, a, o0, o1);
    else
      launch_dkv<128>(bf16, grid, st, a, o0, o1);
  }
}

// The tensor map of a [rows, d] bf16 matrix (d a multiple of 8, the base
// 16-byte aligned) read in boxes of box_rows rows x 64 columns; columns past
// d and rows past the end read zero.
cudaError_t map_bf16(CUtensorMap* map, const void* base, int d,
                     long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tensor_map_bf16(map, base, 2, dims, strides, box);
}

template <class Kernel, class... Params>
cudaError_t launch_ws(Kernel kernel, int smem, dim3 grid, cudaStream_t st,
                      Params... params) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWsThreads, smem, st>>>(params...);
  return cudaGetLastError();
}

cudaError_t dq_wgmma(int bh, cudaStream_t st, const Args& a, void* dq,
                     void* drh, void* drw) {
  const long long rows = (long long)bh * a.n;
  CUtensorMap q_map{}, do_map{}, k_map{}, v_map{};
  cudaError_t err = map_bf16(&q_map, a.q, a.d, rows, kTile);
  if (err == cudaSuccess) err = map_bf16(&do_map, a.dout, a.d, rows, kTile);
  if (err == cudaSuccess) err = map_bf16(&k_map, a.k, a.d, rows, 64);
  if (err == cudaSuccess) err = map_bf16(&v_map, a.v, a.d, rows, 64);
  if (err != cudaSuccess) return err;
  return launch_ws(relpos_dq_wgmma, kDqSmem,
                   dim3((a.n + kTile - 1) / kTile, bh), st, q_map, do_map,
                   k_map, v_map, a.rel_h, a.rel_w, a.lse, a.delta,
                   static_cast<__nv_bfloat16*>(dq), static_cast<float*>(drh),
                   static_cast<float*>(drw), a.n, a.d, a.k_h, a.scale,
                   a.scale * kLog2e);
}

cudaError_t dkv_wgmma(int bh, cudaStream_t st, const Args& a, void* dk,
                      void* dv) {
  const long long rows = (long long)bh * a.n;
  CUtensorMap q_map{}, do_map{}, k_map{}, v_map{}, rw_map{};
  cudaError_t err = map_bf16(&q_map, a.q, a.d, rows, 64);
  if (err == cudaSuccess) err = map_bf16(&do_map, a.dout, a.d, rows, 64);
  if (err == cudaSuccess) err = map_bf16(&k_map, a.k, a.d, rows, kTile);
  if (err == cudaSuccess) err = map_bf16(&v_map, a.v, a.d, rows, kTile);
  if (err == cudaSuccess) {
    // rel_w [rows, 64] f32 in boxes of 64 rows x 32 columns
    const cuuint64_t dims[2] = {64, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {64 * 4};
    const cuuint32_t box[2] = {32, 64};
    err = tensor_map_f32(&rw_map, a.rel_w, 2, dims, strides, box);
  }
  if (err != cudaSuccess) return err;
  return launch_ws(relpos_dkv_wgmma, kDkvSmem, dim3((a.k_h + 1) / 2, bh), st,
                   q_map, do_map, k_map, v_map, rw_map, a.rel_h, a.lse,
                   a.delta, static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), a.n, a.d, a.k_h, a.scale,
                   a.scale * kLog2e);
}

bool bad_shape(int bh, int n, int d, int k_h, int k_w, int is_bf16) {
  return bh < 1 || bh > 65535 || k_h < 1 || k_w < 1 || k_w > kKeys ||
         (long long)k_h * k_w != n || d < 1 || d > 128 ||
         (is_bf16 && d % 2 != 0);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether the wgmma kernels take these bf16 inputs (see the note above).
bool wgmma_shape(const Args& a) {
  return a.k_w == 64 && a.d % 8 == 0 && a.d <= 64 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
}

int relpos_bwd(bool dq_side, bool narrow, const void* q, const void* k,
               const void* v, const void* dout, const void* rel_h,
               const void* rel_w, const void* lse, const void* delta,
               void* o0, void* o1, void* o2, int bh, int n, int d, int k_h,
               int k_w, int is_bf16, float scale, void* stream) {
  if (bad_shape(bh, n, d, k_h, k_w, is_bf16) || (narrow && !is_bf16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, dout, static_cast<const float*>(rel_h),
               static_cast<const float*>(rel_w),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), n, d, k_h, k_w, scale};
  if (is_bf16 && !narrow) {
    if (!wgmma_shape(a)) return cudaErrorInvalidValue;
    return static_cast<int>(dq_side ? dq_wgmma(bh, st, a, o0, o1, o2)
                                    : dkv_wgmma(bh, st, a, o0, o1));
  }
  launch_sync_or_f32(dq_side, is_bf16, bh, st, a, o0, o1, o2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous: q, k, v, dout, dq, dk, dv [BH, N, d] in one dtype
// (bf16 or f32); rel_h, drh [BH, N, k_h], rel_w, drw [BH, N, k_w], lse and
// delta [BH, N] in f32. Every entry returns a cudaError_t:
// cudaErrorInvalidValue for shapes or pointers its kernels do not take, else
// the launch's own status.
//
// flash_relpos_dq, flash_relpos_dkv: bf16 through the wgmma kernels (k_w 64,
// d a multiple of 8 up to 64, q, k, v, dout 16-byte aligned), f32 through
// the FMA kernels.
extern "C" int flash_relpos_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* rel_h,
                               const void* rel_w, const void* lse,
                               const void* delta, void* dq, void* drh,
                               void* drw, int bh, int n, int d, int k_h,
                               int k_w, int is_bf16, float scale,
                               void* stream) {
  return relpos_bwd(true, false, q, k, v, dout, rel_h, rel_w, lse, delta, dq,
                    drh, drw, bh, n, d, k_h, k_w, is_bf16, scale, stream);
}

extern "C" int flash_relpos_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* rel_h,
                                const void* rel_w, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int n, int d, int k_h, int k_w, int is_bf16,
                                float scale, void* stream) {
  return relpos_bwd(false, false, q, k, v, dout, rel_h, rel_w, lse, delta, dk,
                    dv, nullptr, bh, n, d, k_h, k_w, is_bf16, scale, stream);
}

// flash_relpos_dq_narrow, flash_relpos_dkv_narrow: bf16 only (is_bf16 must
// be 1), through the mma.sync kernels, for any k_w <= 64 and even d <= 128
// with 4-byte aligned rows (the same arguments).
extern "C" int flash_relpos_dq_narrow(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* rel_h, const void* rel_w,
                                      const void* lse, const void* delta,
                                      void* dq, void* drh, void* drw, int bh,
                                      int n, int d, int k_h, int k_w,
                                      int is_bf16, float scale,
                                      void* stream) {
  return relpos_bwd(true, true, q, k, v, dout, rel_h, rel_w, lse, delta, dq,
                    drh, drw, bh, n, d, k_h, k_w, is_bf16, scale, stream);
}

extern "C" int flash_relpos_dkv_narrow(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* rel_h, const void* rel_w,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int n,
                                       int d, int k_h, int k_w, int is_bf16,
                                       float scale, void* stream) {
  return relpos_bwd(false, true, q, k, v, dout, rel_h, rel_w, lse, delta, dk,
                    dv, nullptr, bh, n, d, k_h, k_w, is_bf16, scale, stream);
}
