// Flash attention backward with SAM's decomposed relative-position bias, for
// Hopper (sm_90a): two kernels that replace the Pallas kernels
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
//   flash_relpos_dq:   dq = d^-0.5 * ds k          one block per 64 queries,
//                      drh[i, j] = sum_c ds        walking the key rows
//                      drw[i, c] = sum_j ds
//   flash_relpos_dkv:  dv = p^T dO                 one block per key row,
//                      dk = d^-0.5 * ds^T q        walking the queries
// Each block owns its output rows, so there are no atomics and the result is
// deterministic; the [N, N] bias, scores and probabilities never reach device
// memory. p is rounded to bf16 before p^T dO and ds before the dq and dk
// products, where the JAX backward rounds them; drh and drw are sums of the
// unrounded f32 ds.
//
// Bound: at SAM-B's global layers (BH 12, N 4096, d 64, bf16) dq does
// 6*N*N*d*BH = 77 GFLOP and dkv 8*N*N*d*BH = 103 GFLOP over ~60 MB each, so
// both are bound by tensor-core operations. All products run on the tensor
// cores (mma.sync m16n8k16, f32 accumulators) 16 keys or queries at a time,
// so a score tile lives in 16 registers per lane; the dq kernel keeps its
// 64 x k_w drw tile in registers beside dq's 64 x d, reads rel_w through
// the L1 cache, and writes drh 16 columns at a time through shared memory.
// The dkv kernel computes the transposed tiles (keys x queries), which makes
// its accumulators the A operand of both output products; it has one warp per
// 16 keys of the row. The f32 kernels are plain FMA loops kept for
// full-precision checks. Loads are not pipelined yet (no cp.async / TMA /
// wgmma).
//
// Plain C interface, loaded with ctypes; the caller passes contiguous
// tensors and PyTorch's current stream.

#include "flash_mma.cuh"

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

// dq, drh, drw in bf16. Block: 64 queries, 4 warps of 16 query rows; lane
// (g, t) owns rows g and g+8 of its warp and, in every 8-wide key tile,
// columns 2t and 2t+1. The key row is zero-padded to a multiple of 16 keys
// and d to D_PAD.
template <int D_PAD>
__global__ void __launch_bounds__(128)
relpos_dq_bf16(const __nv_bfloat16* __restrict__ q,
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
relpos_dkv_bf16(const __nv_bfloat16* __restrict__ q,
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
    relpos_dq_bf16<D_PAD><<<grid, 128, 0, st>>>(
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
    relpos_dkv_bf16<D_PAD><<<grid, 32 * ((a.k_w + 15) / 16), 0, st>>>(
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

bool bad_shape(int bh, int n, int d, int k_h, int k_w, int is_bf16) {
  return bh < 1 || bh > 65535 || k_h < 1 || k_w < 1 || k_w > kKeys ||
         (long long)k_h * k_w != n || d < 1 || d > 128 ||
         (is_bf16 && d % 2 != 0);
}

}  // namespace

// All tensors contiguous: q, k, v, dout, dq, dk, dv [BH, N, d] in one dtype
// (bf16 or f32); rel_h, drh [BH, N, k_h], rel_w, drw [BH, N, k_w], lse and
// delta [BH, N] in f32. Both functions return a cudaError_t:
// cudaErrorInvalidValue for shapes the kernels do not take, else the
// launch's own status.
extern "C" int flash_relpos_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* rel_h,
                               const void* rel_w, const void* lse,
                               const void* delta, void* dq, void* drh,
                               void* drw, int bh, int n, int d, int k_h,
                               int k_w, int is_bf16, float scale,
                               void* stream) {
  if (bad_shape(bh, n, d, k_h, k_w, is_bf16)) return cudaErrorInvalidValue;
  const dim3 grid((n + kBlock - 1) / kBlock, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, dout, static_cast<const float*>(rel_h),
               static_cast<const float*>(rel_w),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), n, d, k_h, k_w, scale};
  float* rh = static_cast<float*>(drh);
  float* rw = static_cast<float*>(drw);
  if (d <= 64)
    launch_dq<64>(is_bf16, grid, st, a, dq, rh, rw);
  else if (d <= 80)
    launch_dq<80>(is_bf16, grid, st, a, dq, rh, rw);
  else
    launch_dq<128>(is_bf16, grid, st, a, dq, rh, rw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_relpos_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* rel_h,
                                const void* rel_w, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int n, int d, int k_h, int k_w, int is_bf16,
                                float scale, void* stream) {
  if (bad_shape(bh, n, d, k_h, k_w, is_bf16)) return cudaErrorInvalidValue;
  const dim3 grid(k_h, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, dout, static_cast<const float*>(rel_h),
               static_cast<const float*>(rel_w),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), n, d, k_h, k_w, scale};
  if (d <= 64)
    launch_dkv<64>(is_bf16, grid, st, a, dk, dv);
  else if (d <= 80)
    launch_dkv<80>(is_bf16, grid, st, a, dk, dv);
  else
    launch_dkv<128>(is_bf16, grid, st, a, dk, dv);
  return static_cast<int>(cudaGetLastError());
}
