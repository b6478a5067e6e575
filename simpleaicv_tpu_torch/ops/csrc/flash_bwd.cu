// Flash attention backward for Hopper (sm_90a): two kernels, K2 and K3, that
// replace the Pallas kernels simpleaicv_tpu/ops/flash_attention.py::_dq_kernel
// and ::_dkv_kernel (the FlashAttention-2 backward).
//
// From q, k, v, dO [B, H, N, d], the forward's row logsumexp lse (natural
// log) and delta = rowsum(dO * o) (both f32, [B*H, N]) they recompute
//   p  = exp(d^-0.5 * q k^T - lse)        (keys past N give p = 0)
//   ds = p * (dO v^T - delta)
// and accumulate
//   flash_dq (K2):  dq = d^-0.5 * ds k    query-major: a block owns its
//                                         query rows and walks the keys
//   flash_dkv (K3): dv = p^T dO           key-major: a block owns its keys
//                   dk = d^-0.5 * ds^T q  and walks the queries
// p is rounded to bf16 before p^T dO and ds before the dq and dk products,
// where the JAX backward rounds them. The [N, N] scores never reach device
// memory, and every tensor is read in place through its strides.
//
// Two kernels, each owning its output rows: no atomics, and the same bits on
// every launch. A single key-major kernel (FlashAttention-3's) would add f32
// atomics into dq and a conversion pass, and lose that property.
//
// Bound: at ViT-B/16 batch 128 (BH 1536, N 197, d 64, bf16) K2 does 3
// products, 6*N*N*d*BH = 22.9 GFLOP, over 196 MB and K3 4, 30.5 GFLOP, over
// 235 MB: both bound by bytes, 0.0585 and 0.0701 ms at 3.35 TB/s. The
// previous design (kept as the narrow variant: 64-row blocks, 6144 a
// kernel, each re-reading its head's other side; 4-byte synchronous loads
// into registers and padded tiles between __syncthreads; mma.sync
// m16n8k16 with the exponentials serial with the products) took 0.3724 and
// 0.4755 ms on an H100 at 700 W, 61 and 64 TFLOP/s.
//
// bf16, the path's kernels (flash_dq_wgmma, flash_dkv_wgmma), on the plan of
// flash_relpos_bwd.cu's K5 and K6 without the bias: a block of two consumer
// warpgroups of 64 rows and a producer warpgroup, which fills shared memory
// by TMA (128-byte swizzle; q, k, v and dO as 4-D tensor maps over (d,
// head, token, batch) on the strided views, as flash_fwd.cu reads them;
// rows past N read zero) and gives its registers to the consumers
// (setmaxnreg). mbarriers count the bytes in and the consumer warps out;
// every wait traps after 2^32 cycles instead of hanging.
//   - Persistent: a grid of one block an SM (at most one an item) walks the
//     (head, 128-row tile) items in a fixed order, item = blockIdx.x +
//     i * gridDim.x, the row tile fast, so that a head's items run side by
//     side and read its other side from L2, and every launch gives the
//     same bits. An item's own tiles (K2: Q and dO; K3: K and V, [128, 64]
//     each) sit in one of two slots, so the producer loads item i + 1's
//     while the consumers finish item i; the other side streams through a
//     4-stage ring of 64-row tiles that runs on across items (its mbarrier
//     parities carry over) and at N 197 holds a whole head.
//   - One stream of tiles: the consumers walk the block's items as one
//     sequence of the other side's tiles. Step v issues tile v's score
//     products with tile v - 1's output products and computes tile v's
//     exponentials and ds while the latter are in flight; the two
//     warpgroups take turns to issue (named barriers). At an item's first
//     step the output products complete the previous item, which is stored
//     while the new item's scores run; the item's first output product
//     overwrites the accumulators (scale-d 0), so an item boundary costs no
//     step of its own.
//   - Every product is issued on every step, unconditionally (the block's
//     first output products multiply zero fragments, its last score
//     products read a stale stage and are not used): ptxas serialises all
//     of a kernel's wgmma (its notes C7515 and C7520) when one of them sits
//     under a condition, or when a non-wgmma instruction writes an
//     accumulator while products are in flight. So the tail of the other
//     side is a whole 64-row tile: a 16-wide product for the 5-row tail at
//     N 197 would be a product under a condition. (A first version with
//     that tail and with products under conditions at an item's first and
//     last steps had every product serialised, and was the slower one.)
//   - K2: per key tile S = Q K^T and dP = dO V^T (wgmma, both operands
//     from shared memory, K-major), then ds in registers, then dQ += ds K
//     with ds from registers as bf16 and K read MN-major through its
//     descriptor. lse and delta of the thread's two rows come by ordinary
//     loads one item ahead (a [BH, N] f32 row of 788 bytes at N 197 has no
//     16-byte stride for a tensor map). Keys past N read zero rows of K and
//     V, so their ds multiplies a zero row of K and adds nothing.
//   - K3: the tiles are transposed (keys x queries): S^T = K Q^T and
//     dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//     from registers and dO, Q read MN-major; nothing is transposed in
//     memory. A second producer warp puts -lse log2 e and delta of each
//     query tile into its stage (-inf and 0 past N, which makes p = 0).
//   - The exponent is in base 2: one FMA a score folds d^-0.5 log2 e and
//     lse log2 e, and ex2.approx takes it.
//   - Padding: the rows a block owns and the other side are 64-granular,
//     256 of each a head at N 197 (197 real), so the kernels compute 1.69
//     times the useful products (38.7 GFLOP for K2, 51.5 for K3 at
//     ViT-B/16 b128).
//   - Outputs: each warpgroup rounds its rows to bf16 into its half of the
//     item's slot (no product reads it then), then stores them 16 bytes a
//     thread into the [B, N, H, d] storage the wrapper allocates.
//   - Served: bf16 with d a multiple of 8 up to 64 and every row of q, k,
//     v, dO and the outputs 16-byte aligned (ViT-B/16's and ViT-S/16's
//     layers, d 64).
// bf16 otherwise (flash_dq_sync, flash_dkv_sync, exported as flash_dq_narrow
// and flash_dkv_narrow; chosen by ops/flash_attention.py::_flash_bwd_variant):
// the previous design's mma.sync kernels, for d 80 (ViT-H) and 128, even
// d that is no multiple of 8, and rows that are 4-byte but not 16-byte
// aligned.
// The f32 kernels are plain FMA loops kept for full-precision checks.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8):
// flash_dq_wgmma and flash_dkv_wgmma 168 registers at entry (384 threads;
// setmaxnreg then gives each consumer thread 240 and the producer 24), no
// spills, 132,192 and 136,288 bytes of dynamic shared memory, one block an
// SM, and ptxas's notes C7517 and C7519 once each (score_products); the
// narrow flash_dq_sync<64> and flash_dkv_sync<64> 128 and 166 registers,
// no spills.
//
// Plain C interface, loaded with ctypes; the caller passes PyTorch's current
// stream and element strides (unit stride over d).

#include "flash_items.cuh"

namespace {

constexpr int kBlock = 64;  // output rows per block of the narrow kernels
constexpr int kTile = 64;   // rows of the other side per shared-memory tile

// ----------------- bf16, mma.sync (the narrow variants) -------------------

// Block: 64 queries, 4 warps of 16 query rows; lane (g, t) owns rows g and
// g+8 of its warp.
template <int D_PAD>
__global__ void __launch_bounds__(128)
flash_dq_sync(View q, View k, View v, View dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              View dq, int heads, int n, int d, float scale) {
  constexpr int STR = D_PAD + 8;
  constexpr int DK = D_PAD / 16;
  constexpr int DT = D_PAD / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * STR];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * STR];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kBlock + warp * 16 + g;
  const int row1 = row0 + 8;
  const __nv_bfloat16* kh = head_ptr<__nv_bfloat16>(k, bh, heads);
  const __nv_bfloat16* vh = head_ptr<__nv_bfloat16>(v, bh, heads);

  uint32_t qf[DK][4], dof[DK][4];
  ld_a_global<D_PAD>(qf, head_ptr<__nv_bfloat16>(q, bh, heads), q.sn, row0, n,
                     d, t);
  ld_a_global<D_PAD>(dof, head_ptr<__nv_bfloat16>(dout, bh, heads), dout.sn,
                     row0, n, d, t);
  const float lse0 = row0 < n ? lse[(size_t)bh * n + row0] : 0.f;
  const float lse1 = row1 < n ? lse[(size_t)bh * n + row1] : 0.f;
  const float dl0 = row0 < n ? delta[(size_t)bh * n + row0] : 0.f;
  const float dl1 = row1 < n ? delta[(size_t)bh * n + row1] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int key0 = 0; key0 < n; key0 += kTile) {
    __syncthreads();
    stage_tile<kTile, D_PAD, STR, 128>(ks, kh, k.sn, key0, n, d);
    stage_tile<kTile, D_PAD, STR, 128>(vs, vh, v.sn, key0, n, d);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (key0 + kk * 16 < n) {  // else the rest of the tile is padding
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
            const bool valid = key0 + kk * 16 + h * 8 + 2 * t + e < n;
            const float p0 = valid ? expf(s[h][e] * scale - lse0) : 0.f;
            const float p1 = valid ? expf(s[h][2 + e] * scale - lse1) : 0.f;
            s[h][e] = p0 * (dp[h][e] - dl0);  // ds, in place of s
            s[h][2 + e] = p1 * (dp[h][2 + e] - dl1);
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
  }

  __nv_bfloat16* out = head_ptr<__nv_bfloat16>(dq, bh, heads);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c < d) {
      if (row0 < n)
        *reinterpret_cast<__nv_bfloat162*>(out + row0 * dq.sn + c) =
            __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
      if (row1 < n)
        *reinterpret_cast<__nv_bfloat162*>(out + row1 * dq.sn + c) =
            __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

// Block: 64 keys, 4 warps of 16 key rows; lane (g, t) owns key rows g and
// g+8 of its warp. Tiles are transposed: rows are keys, columns queries.
// Padded query columns carry lse = +inf, so their p and ds are exactly 0.
template <int D_PAD>
__global__ void __launch_bounds__(128)
flash_dkv_sync(View q, View k, View v, View dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               View dk, View dv, int heads, int n, int d, float scale) {
  constexpr int STR = D_PAD + 8;
  constexpr int DK = D_PAD / 16;
  constexpr int DT = D_PAD / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * STR];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * STR];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kBlock + warp * 16 + g;
  const int row1 = row0 + 8;
  const __nv_bfloat16* qh = head_ptr<__nv_bfloat16>(q, bh, heads);
  const __nv_bfloat16* doh = head_ptr<__nv_bfloat16>(dout, bh, heads);

  uint32_t kf[DK][4], vf[DK][4];
  ld_a_global<D_PAD>(kf, head_ptr<__nv_bfloat16>(k, bh, heads), k.sn, row0, n,
                     d, t);
  ld_a_global<D_PAD>(vf, head_ptr<__nv_bfloat16>(v, bh, heads), v.sn, row0, n,
                     d, t);

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    stage_tile<kTile, D_PAD, STR, 128>(qs, qh, q.sn, q0, n, d);
    stage_tile<kTile, D_PAD, STR, 128>(dos, doh, dout.sn, q0, n, d);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      ls[threadIdx.x] = r < n ? lse[(size_t)bh * n + r] : INFINITY;
      dls[threadIdx.x] = r < n ? delta[(size_t)bh * n + r] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
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
            const float l = ls[col], dl = dls[col];
            p[h][e] = expf(p[h][e] * scale - l);
            p[h][2 + e] = expf(p[h][2 + e] * scale - l);
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

  __nv_bfloat16* dkh = head_ptr<__nv_bfloat16>(dk, bh, heads);
  __nv_bfloat16* dvh = head_ptr<__nv_bfloat16>(dv, bh, heads);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c < d) {
      if (row0 < n) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + row0 * dk.sn + c) =
            __floats2bfloat162_rn(dka[dt][0] * scale, dka[dt][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvh + row0 * dv.sn + c) =
            __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
      }
      if (row1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + row1 * dk.sn + c) =
            __floats2bfloat162_rn(dka[dt][2] * scale, dka[dt][3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvh + row1 * dv.sn + c) =
            __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
      }
    }
  }
}

// ---------------------------------- f32 ----------------------------------

constexpr int kSub = 16;  // rows staged per step by the f32 kernels

// Stages rows [row0, row0 + kSub) of two f32 tensors of one head, the first
// multiplied by `mul`; rows >= n and columns >= d are zero.
template <int D_PAD>
__device__ __forceinline__ void stage_f32(float (*a)[D_PAD], float (*b)[D_PAD],
                                          const float* ah, long long a_sn,
                                          const float* bh, long long b_sn,
                                          float mul, int row0, int n, int d) {
  for (int idx = threadIdx.x; idx < kSub * D_PAD; idx += kBlock) {
    const int r = idx / D_PAD, c = idx % D_PAD;
    const bool in = row0 + r < n && c < d;
    a[r][c] = in ? ah[(row0 + r) * a_sn + c] * mul : 0.f;
    b[r][c] = in ? bh[(row0 + r) * b_sn + c] : 0.f;
  }
}

// f32 dq: one thread per query row; keys staged 16 at a time.
template <int D_PAD>
__global__ void __launch_bounds__(kBlock)
flash_dq_f32(View q, View k, View v, View dout, const float* __restrict__ lse,
             const float* __restrict__ delta, View dq, int heads, int n,
             int d, float scale) {
  __shared__ float ks[kSub][D_PAD];
  __shared__ float vs[kSub][D_PAD];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kBlock + threadIdx.x;
  const bool ok = row < n;
  const float* qh = head_ptr<float>(q, bh, heads);
  const float* doh = head_ptr<float>(dout, bh, heads);
  const float* kh = head_ptr<float>(k, bh, heads);
  const float* vh = head_ptr<float>(v, bh, heads);

  float qr[D_PAD], dor[D_PAD], acc[D_PAD];
#pragma unroll
  for (int i = 0; i < D_PAD; ++i) {
    qr[i] = (ok && i < d) ? qh[row * q.sn + i] * scale : 0.f;
    dor[i] = (ok && i < d) ? doh[row * dout.sn + i] : 0.f;
    acc[i] = 0.f;
  }
  const float l = ok ? lse[(size_t)bh * n + row] : 0.f;
  const float dl = ok ? delta[(size_t)bh * n + row] : 0.f;

  for (int key0 = 0; key0 < n; key0 += kSub) {
    const int cnt = min(kSub, n - key0);
    __syncthreads();
    stage_f32<D_PAD>(ks, vs, kh, k.sn, vh, v.sn, 1.f, key0, n, d);
    __syncthreads();
    for (int r = 0; r < cnt; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < D_PAD; ++i) {
        s = fmaf(qr[i], ks[r][i], s);
        dp = fmaf(dor[i], vs[r][i], dp);
      }
      const float ds = expf(s - l) * (dp - dl);
#pragma unroll
      for (int i = 0; i < D_PAD; ++i) acc[i] = fmaf(ds, ks[r][i], acc[i]);
    }
  }
  if (ok) {
    float* out = head_ptr<float>(dq, bh, heads);
#pragma unroll
    for (int i = 0; i < D_PAD; ++i)
      if (i < d) out[row * dq.sn + i] = acc[i] * scale;
  }
}

// f32 dk, dv: one thread per key row; queries (scaled by d^-0.5, so dk
// carries the scale) and dO staged 16 at a time.
template <int D_PAD>
__global__ void __launch_bounds__(kBlock)
flash_dkv_f32(View q, View k, View v, View dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              View dk, View dv, int heads, int n, int d, float scale) {
  __shared__ float qs[kSub][D_PAD];
  __shared__ float dos[kSub][D_PAD];
  __shared__ float ls[kSub];
  __shared__ float dls[kSub];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kBlock + threadIdx.x;
  const bool ok = row < n;
  const float* qh = head_ptr<float>(q, bh, heads);
  const float* doh = head_ptr<float>(dout, bh, heads);
  const float* kh = head_ptr<float>(k, bh, heads);
  const float* vh = head_ptr<float>(v, bh, heads);

  float kr[D_PAD], vr[D_PAD], dkr[D_PAD], dvr[D_PAD];
#pragma unroll
  for (int i = 0; i < D_PAD; ++i) {
    kr[i] = (ok && i < d) ? kh[row * k.sn + i] : 0.f;
    vr[i] = (ok && i < d) ? vh[row * v.sn + i] : 0.f;
    dkr[i] = dvr[i] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kSub) {
    const int cnt = min(kSub, n - q0);
    __syncthreads();
    stage_f32<D_PAD>(qs, dos, qh, q.sn, doh, dout.sn, scale, q0, n, d);
    if (threadIdx.x < cnt) {
      ls[threadIdx.x] = lse[(size_t)bh * n + q0 + threadIdx.x];
      dls[threadIdx.x] = delta[(size_t)bh * n + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int r = 0; r < cnt; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < D_PAD; ++i) {
        s = fmaf(kr[i], qs[r][i], s);
        dp = fmaf(vr[i], dos[r][i], dp);
      }
      const float p = expf(s - ls[r]);
      const float ds = p * (dp - dls[r]);
#pragma unroll
      for (int i = 0; i < D_PAD; ++i) {
        dvr[i] = fmaf(p, dos[r][i], dvr[i]);
        dkr[i] = fmaf(ds, qs[r][i], dkr[i]);
      }
    }
  }
  if (ok) {
    float* dkh = head_ptr<float>(dk, bh, heads);
    float* dvh = head_ptr<float>(dv, bh, heads);
#pragma unroll
    for (int i = 0; i < D_PAD; ++i)
      if (i < d) {
        dkh[row * dk.sn + i] = dkr[i];
        dvh[row * dv.sn + i] = dvr[i];
      }
  }
}

// ------------------- bf16, wgmma + TMA (the path's kernels) -----------------

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kWsThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kStages = 4;                    // stages of the ring
constexpr uint32_t kSlot = 4 * kBox;          // an item's two [128][64] tiles

// The two score products of a tile: acc0 += A0 B0^T and acc1 += A1 B1^T
// over 64 columns of d (16 at a time: 32 bytes into each swizzled row),
// onto accumulators the caller has set to 0. NVVM copies acc1's zeros from
// acc0's first register, so ptxas waits for the acc0 products before it
// issues acc1's (its note C7517). In alternating rounds on an H100 that was
// faster than both ways around the wait: each zero pinned in its own
// register, or no zeros and scale-d 0 on the first step.
__device__ __forceinline__ void score_products(float (&acc0)[32],
                                               float (&acc1)[32],
                                               uint64_t a0, uint64_t b0,
                                               uint64_t a1, uint64_t b1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<64>(acc0, a0 + 2 * kk, b0 + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<64>(acc1, a1 + 2 * kk, b1 + 2 * kk, 1);
}

// K2: ds in place of the score accumulators: p = 2^(s d^-0.5 log2 e -
// lse log2 e), ds = p (dP - delta), with rows[] = (-lse log2 e, delta) of
// the thread's rows a (accumulators i % 4 < 2) and b.
__device__ __forceinline__ void dq_ds(float (&s)[32], const float (&dp)[32],
                                      float scale_log2,
                                      const float (&rows)[4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool a = (i % 4) < 2;
    const float p = exp2_approx(fmaf(s[i], scale_log2, rows[a ? 0 : 1]));
    s[i] = p * (dp[i] - rows[a ? 2 : 3]);
  }
}

// K2: rows[] of the thread's rows a and b of an item: -lse log2 e (-inf
// past N, which makes p = 0) and delta.
__device__ __forceinline__ void load_rows(float (&rows)[4],
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          size_t head_row, int row_a, int n) {
  const int row_b = row_a + 8;
  rows[0] = row_a < n ? -lse[head_row + row_a] * kLog2e : -INFINITY;
  rows[1] = row_b < n ? -lse[head_row + row_b] * kLog2e : -INFINITY;
  rows[2] = row_a < n ? delta[head_row + row_a] : 0.f;
  rows[3] = row_b < n ? delta[head_row + row_b] : 0.f;
}

// K3: p^T in place of s^T and ds^T in place of dP^T; accumulator i is query
// column 8 (i / 4) + 2t + i % 2 of the tile, whose -lse log2 e and delta are
// cols[q] and cols[64 + q].
__device__ __forceinline__ void dkv_p_ds(float (&s)[32], float (&dp)[32],
                                         const float* cols, int t,
                                         float scale_log2) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int qc = 8 * jj + 2 * t;
    const float2 nl = *reinterpret_cast<const float2*>(cols + qc);
    const float2 dl = *reinterpret_cast<const float2*>(cols + 64 + qc);
#pragma unroll
    for (int i = 4 * jj; i < 4 * jj + 4; ++i) {
      const bool odd = i % 2;
      const float p = exp2_approx(fmaf(s[i], scale_log2, odd ? nl.y : nl.x));
      dp[i] = p * (dp[i] - (odd ? dl.y : dl.x));
      s[i] = p;
    }
  }
}

// K2's dynamic shared memory: 1024 bytes to align the swizzled tiles, two
// slots of Q and dO [128][64], the ring of K/V stages and the mbarriers.
constexpr int kDqSmem = 1024 + 2 * kSlot + kStages * 2 * kBox +
                        (2 * kStages + 4) * 8;

// dq for the items of this block. Warpgroup wg owns rows 64 wg .. 64 wg + 63
// of an item; warp w of it holds rows 16w + g and 16w + g + 8 (a and b) and
// accumulator i is column 8 (i / 4) + 2t + i % 2 of row a (i % 4 < 2) or b.
__global__ void __launch_bounds__(kWsThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const float* __restrict__ lse,
               const float* __restrict__ delta, View dq, int batch,
               int heads, int n, int d, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t slots = (s0 + 1023) & ~1023u;  // slot x: Q, then dO
  const uint32_t ring = slots + 2 * kSlot;      // stage s: K, then V
  // full[s]: TMA's bytes; empty[s]: the 8 consumer warps, once their
  // products have read the stage; res_full[x], res_empty[x]: the same for
  // slot x
  const uint32_t full = ring + kStages * 2 * kBox;
  const uint32_t empty = full + kStages * 8;
  const uint32_t res_full = empty + kStages * 8;
  const uint32_t res_empty = res_full + 2 * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Walk walk(batch * heads, n);
  const int count = walk.count();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(res_full + 8 * x, 1);
      mbar_init(res_empty + 8 * x, kConsumers / 32);
    }
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer: one thread loads item i's Q and dO into slot i % 2 once
    // the consumers have released item i - 2, then its key tiles into the
    // ring, tile g (counted over the block's walk) into stage g % kStages
    setmaxnreg_dec<24>();
    if (warp == kConsumers / 32 && lane == 0) {
      int g = 0;
      for (int i = 0; i < count; ++i) {
        const int item = blockIdx.x + i * gridDim.x;
        const int bh = item / walk.row_tiles;
        const int b = bh / heads, h = bh % heads;
        const int x = i & 1;
        const uint32_t qs = slots + x * kSlot;
        if (i >= 2) mbar_wait(res_empty + 8 * x, ((i >> 1) - 1) & 1);
        mbar_arrive_expect_tx(res_full + 8 * x, kSlot);
        const int r0 = (item % walk.row_tiles) * kRows;
        tma_load_4d(qs, &q_map, 0, h, r0, b, res_full + 8 * x);
        tma_load_4d(qs + 2 * kBox, &do_map, 0, h, r0, b, res_full + 8 * x);
        for (int u = 0; u < walk.tiles; ++u, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty + 8 * s, (g / kStages - 1) & 1);
          const uint32_t ks = ring + s * 2 * kBox;
          mbar_arrive_expect_tx(full + 8 * s, 2 * kBox);
          tma_load_4d(ks, &k_map, 0, h, u * 64, b, full + 8 * s);
          tma_load_4d(ks + kBox, &v_map, 0, h, u * 64, b, full + 8 * s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int wrow = wg * 64 + (warp % 4) * 16 + g;  // row a within an item
  const int tiles = walk.tiles, steps = count * tiles;
  float rows[4], next_rows[4];  // this item's and the next one's
  load_rows(next_rows, lse, delta, (size_t)(blockIdx.x / walk.row_tiles) * n,
            (blockIdx.x % walk.row_tiles) * kRows + wrow, n);
  float dq_acc[32];
  uint32_t dsf[4][4] = {};  // the previous tile's ds, bf16 A fragments

  // One stream of key tiles over the block's items: step v issues S = Q K^T
  // and dP = dO V^T of tile v, then dQ += ds K of tile v - 1, and computes
  // tile v's ds while the latter is in flight; at an item's first step the
  // dQ product completes the previous item, whose dq is stored. Every
  // product is issued on every step (the last step's scores read a stale
  // stage and are not used): a product under a condition makes ptxas
  // serialise them all. The warpgroups take turns to issue (named barriers
  // 1 and 2, warpgroup 0 first; warpgroup 0 takes the last arrival).
  if (wg == 1) named_bar_arrive(1, kConsumers);
  for (int v = 0; v <= steps; ++v) {
    const int i = v / tiles, u = v - i * tiles;  // the scores' item, tile
    const int s = v % kStages, prev = (v + kStages - 1) % kStages;
    const uint32_t qs = slots + (i & 1) * kSlot;
    float sacc[32], pacc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = pacc[j] = 0.f;
    if (v < steps) {
      if (u == 0) {
        mbar_wait(res_full + 8 * (i & 1), (i >> 1) & 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) rows[j] = next_rows[j];
        if (i + 1 < count) {
          const int item = blockIdx.x + (i + 1) * gridDim.x;
          load_rows(next_rows, lse, delta,
                    (size_t)(item / walk.row_tiles) * n,
                    (item % walk.row_tiles) * kRows + wrow, n);
        }
      }
      mbar_wait(full + 8 * s, (v / kStages) & 1);
    }
    named_bar_sync(1 + wg, kConsumers);
    wgmma_fence();
    const uint64_t desc_k = wgmma_desc_sw128(ring + s * 2 * kBox);
    score_products(sacc, pacc, wgmma_desc_sw128(qs + wg * kBox), desc_k,
                   wgmma_desc_sw128(qs + 2 * kBox + wg * kBox),
                   wgmma_desc_sw128(ring + s * 2 * kBox + kBox));
    wgmma_commit();
    // K read MN-major; the item's first tile overwrites dq_acc
    out_product(dq_acc, dsf, wgmma_desc_sw128(ring + prev * 2 * kBox),
                u == (tiles > 1 ? 1 : 0));
    wgmma_commit();
    named_bar_arrive(2 - wg, kConsumers);
    wgmma_wait<1>();  // S and dP are ready; dQ may still run
    fence_operands(sacc);
    fence_operands(pacc);
    dq_ds(sacc, pacc, scale_log2, rows);
    wgmma_wait<0>();  // dQ += ds_{v-1} K_{v-1} is done: the stage is free
    fence_operands(dq_acc);
    if (v > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    if (u == 0 && v > 0) {
      // item i - 1 is complete: dq through the warpgroup's half of its Q
      // tile, which no product reads now, then 16 bytes a thread; the slot
      // is free after
      const int item = blockIdx.x + (i - 1) * gridDim.x;
      const int bh = item / walk.row_tiles;
      const uint32_t done = slots + ((i - 1) & 1) * kSlot;
      unsigned char* tile = smem + (done + wg * kBox - s0);
      stage_rows(tile, dq_acc, scale, warp, g, t);
      named_bar_sync(3 + wg, 128);
      store_rows(head_ptr<__nv_bfloat16>(dq, bh, heads), dq.sn, tile,
                 (item % walk.row_tiles) * kRows + wg * 64, n, d, tid % 128);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(res_empty + 8 * ((i - 1) & 1));
    }
    pack_steps(dsf, sacc);
  }
  // warpgroup 1's arrival after its last products
  if (wg == 0) named_bar_sync(1, kConsumers);
}

// K3's ring stage: Q and dO [64][64] bf16, then -lse log2 e and delta of
// the tile's 64 queries (f32), padded to 1024 bytes.
constexpr uint32_t kDkvStage = 2 * kBox + 1024;
constexpr int kDkvSmem = 1024 + 2 * kSlot + kStages * kDkvStage +
                         (2 * kStages + 4) * 8;

// dk, dv for the items of this block. Warpgroup wg owns keys 64 wg ..
// 64 wg + 63 of an item; the tiles are transposed, so warp w holds keys
// 16w + g and 16w + g + 8 (a and b) and accumulator i is query column
// 8 (i / 4) + 2t + i % 2 of the tile.
__global__ void __launch_bounds__(kWsThreads, 1)
flash_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const float* __restrict__ lse,
                const float* __restrict__ delta, View dk, View dv, int batch,
                int heads, int n, int d, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t slots = (s0 + 1023) & ~1023u;  // slot x: K, then V
  const uint32_t ring = slots + 2 * kSlot;      // stage: Q, dO, columns
  // full[s]: TMA's bytes and the 32 lanes of the column warp; empty[s]: the
  // 8 consumer warps; res_full[x], res_empty[x]: slot x
  const uint32_t full = ring + kStages * kDkvStage;
  const uint32_t empty = full + kStages * 8;
  const uint32_t res_full = empty + kStages * 8;
  const uint32_t res_empty = res_full + 2 * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Walk walk(batch * heads, n);
  const int count = walk.count();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(res_full + 8 * x, 1);
      mbar_init(res_empty + 8 * x, kConsumers / 32);
    }
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer: one thread loads item i's K and V into slot i % 2, then
    // its query tiles' Q and dO into the ring; the next warp puts each
    // query tile's columns into the same stage
    setmaxnreg_dec<24>();
    if (warp == kConsumers / 32 && lane == 0) {
      int g = 0;
      for (int i = 0; i < count; ++i) {
        const int item = blockIdx.x + i * gridDim.x;
        const int bh = item / walk.row_tiles;
        const int b = bh / heads, h = bh % heads;
        const int x = i & 1;
        const uint32_t ks = slots + x * kSlot;
        if (i >= 2) mbar_wait(res_empty + 8 * x, ((i >> 1) - 1) & 1);
        mbar_arrive_expect_tx(res_full + 8 * x, kSlot);
        const int r0 = (item % walk.row_tiles) * kRows;
        tma_load_4d(ks, &k_map, 0, h, r0, b, res_full + 8 * x);
        tma_load_4d(ks + 2 * kBox, &v_map, 0, h, r0, b, res_full + 8 * x);
        for (int u = 0; u < walk.tiles; ++u, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty + 8 * s, (g / kStages - 1) & 1);
          const uint32_t st = ring + s * kDkvStage;
          mbar_arrive_expect_tx(full + 8 * s, 2 * kBox);
          tma_load_4d(st, &q_map, 0, h, u * 64, b, full + 8 * s);
          tma_load_4d(st + kBox, &do_map, 0, h, u * 64, b, full + 8 * s);
        }
      }
    } else if (warp == kConsumers / 32 + 1) {
      int g = 0;
      for (int i = 0; i < count; ++i) {
        const int item = blockIdx.x + i * gridDim.x;
        const size_t head_row = (size_t)(item / walk.row_tiles) * n;
        for (int u = 0; u < walk.tiles; ++u, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty + 8 * s, (g / kStages - 1) & 1);
          float* cols = reinterpret_cast<float*>(
              smem + (ring + s * kDkvStage + 2 * kBox - s0));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = lane + 32 * half, row = u * 64 + q;
            cols[q] = row < n ? -lse[head_row + row] * kLog2e : -INFINITY;
            cols[64 + q] = row < n ? delta[head_row + row] : 0.f;
          }
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int tiles = walk.tiles, steps = count * tiles;
  float dk_acc[32], dv_acc[32];
  uint32_t pf[4][4] = {}, dsf[4][4] = {};  // the previous tile's P^T, dS^T

  // One stream of query tiles over the block's items, as in K2: step v
  // issues S^T = K Q^T and dP^T = V dO^T of tile v, then dV += P^T dO and
  // dK += dS^T Q of tile v - 1, and computes tile v's P^T and dS^T while
  // the latter are in flight; every product is issued on every step.
  if (wg == 1) named_bar_arrive(1, kConsumers);
  for (int v = 0; v <= steps; ++v) {
    const int i = v / tiles, u = v - i * tiles;  // the scores' item, tile
    const int s = v % kStages, prev = (v + kStages - 1) % kStages;
    const uint32_t ks = slots + (i & 1) * kSlot;
    const uint32_t st = ring + s * kDkvStage, sp = ring + prev * kDkvStage;
    float sacc[32], pacc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = pacc[j] = 0.f;
    if (v < steps) {
      if (u == 0) mbar_wait(res_full + 8 * (i & 1), (i >> 1) & 1);
      mbar_wait(full + 8 * s, (v / kStages) & 1);
    }
    named_bar_sync(1 + wg, kConsumers);
    wgmma_fence();
    score_products(sacc, pacc, wgmma_desc_sw128(ks + wg * kBox),
                   wgmma_desc_sw128(st),
                   wgmma_desc_sw128(ks + 2 * kBox + wg * kBox),
                   wgmma_desc_sw128(st + kBox));
    wgmma_commit();
    // dO and Q read MN-major; the item's first tile overwrites dV and dK
    const bool first = u == (tiles > 1 ? 1 : 0);
    out_product(dv_acc, pf, wgmma_desc_sw128(sp + kBox), first);
    out_product(dk_acc, dsf, wgmma_desc_sw128(sp), first);
    wgmma_commit();
    named_bar_arrive(2 - wg, kConsumers);
    const float* cols =
        reinterpret_cast<const float*>(smem + (st + 2 * kBox - s0));
    wgmma_wait<1>();  // S^T and dP^T are ready; dV and dK may still run
    fence_operands(sacc);
    fence_operands(pacc);
    dkv_p_ds(sacc, pacc, cols, t, scale_log2);
    wgmma_wait<0>();  // tile v - 1's dV and dK are done: its stage is free
    fence_operands(dk_acc);
    fence_operands(dv_acc);
    if (v > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    if (u == 0 && v > 0) {
      // item i - 1 is complete: dk and dv through the warpgroup's halves of
      // its K and V tiles, then 16 bytes a thread; the slot is free after
      const int item = blockIdx.x + (i - 1) * gridDim.x;
      const int bh = item / walk.row_tiles;
      const int r0 = (item % walk.row_tiles) * kRows + wg * 64;
      const uint32_t done = slots + ((i - 1) & 1) * kSlot;
      unsigned char* k_tile = smem + (done + wg * kBox - s0);
      unsigned char* v_tile = smem + (done + 2 * kBox + wg * kBox - s0);
      stage_rows(k_tile, dk_acc, scale, warp, g, t);
      stage_rows(v_tile, dv_acc, 1.f, warp, g, t);
      named_bar_sync(3 + wg, 128);
      store_rows(head_ptr<__nv_bfloat16>(dk, bh, heads), dk.sn, k_tile, r0,
                 n, d, tid % 128);
      store_rows(head_ptr<__nv_bfloat16>(dv, bh, heads), dv.sn, v_tile, r0,
                 n, d, tid % 128);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(res_empty + 8 * ((i - 1) & 1));
    }
    pack_steps(pf, sacc);
    pack_steps(dsf, pacc);
  }
  // warpgroup 1's arrival after its last products
  if (wg == 0) named_bar_sync(1, kConsumers);
}

// The narrow (bf16) or f32 kernels: grid (B*H, 64-row blocks).
template <int D_PAD>
void launch_sync_or_f32(bool dq_side, bool bf16, dim3 grid, cudaStream_t st,
                        View q, View k, View v, View dout, const float* lse,
                        const float* delta, View o0, View o1, int heads,
                        int n, int d, float scale) {
  if (dq_side && bf16)
    flash_dq_sync<D_PAD><<<grid, 128, 0, st>>>(q, k, v, dout, lse, delta, o0,
                                               heads, n, d, scale);
  else if (dq_side)
    flash_dq_f32<D_PAD><<<grid, kBlock, 0, st>>>(q, k, v, dout, lse, delta,
                                                 o0, heads, n, d, scale);
  else if (bf16)
    flash_dkv_sync<D_PAD><<<grid, 128, 0, st>>>(q, k, v, dout, lse, delta, o0,
                                                o1, heads, n, d, scale);
  else
    flash_dkv_f32<D_PAD><<<grid, kBlock, 0, st>>>(q, k, v, dout, lse, delta,
                                                  o0, o1, heads, n, d, scale);
}

struct Args {
  View q, k, v, dout;
  const float *lse, *delta;
  int batch, heads, n, d;
  float scale;
};

// The wgmma kernels: the item's own tensors in boxes of 128 tokens, the
// other side's in boxes of 64; a grid of one block an SM, at most one a
// item.
cudaError_t launch_wgmma(bool dq_side, cudaStream_t st, const Args& a,
                         View o0, View o1) {
  CUtensorMap maps[4];  // q, dO, k, v
  const View* views[4] = {&a.q, &a.dout, &a.k, &a.v};
  for (int i = 0; i < 4; ++i) {
    const bool own = dq_side == (i < 2);
    const cudaError_t err = map_view(&maps[i], *views[i], a.batch, a.heads,
                                     a.n, a.d, own ? kRows : 64);
    if (err != cudaSuccess) return err;
  }
  int grid = 0;
  cudaError_t err = persistent_grid(
      (long long)a.batch * a.heads * ((a.n + kRows - 1) / kRows), &grid);
  if (err != cudaSuccess) return err;
  const float scale_log2 = a.scale * kLog2e;
  if (dq_side) {
    err = cudaFuncSetAttribute(flash_dq_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
    if (err != cudaSuccess) return err;
    flash_dq_wgmma<<<grid, kWsThreads, kDqSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, o0, a.batch,
        a.heads, a.n, a.d, a.scale, scale_log2);
  } else {
    err = cudaFuncSetAttribute(flash_dkv_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
    if (err != cudaSuccess) return err;
    flash_dkv_wgmma<<<grid, kWsThreads, kDkvSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], a.lse, a.delta, o0, o1, a.batch,
        a.heads, a.n, a.d, a.scale, scale_log2);
  }
  return cudaGetLastError();
}

bool bad_shape(int batch, int heads, int n, int d, int is_bf16) {
  return batch < 1 || heads < 1 || n < 1 || d < 1 || d > 128 ||
         (is_bf16 && d % 2 != 0) || (n + kBlock - 1) / kBlock > 65535 ||
         (long long)batch * heads * ((n + kRows - 1) / kRows) >= (1LL << 31);
}

// One backward entry: the wgmma kernels for bf16 (unless narrow), the
// mma.sync kernels for narrow bf16, the FMA kernels for f32.
int flash_bwd(bool dq_side, bool narrow, const Args& a, View o0, View o1,
              int is_bf16, cudaStream_t st) {
  if (bad_shape(a.batch, a.heads, a.n, a.d, is_bf16) || (narrow && !is_bf16))
    return cudaErrorInvalidValue;
  if (is_bf16 && !narrow) {
    const bool outs_ok = rows_aligned(o0, 16) &&
                         (dq_side || rows_aligned(o1, 16));
    if (a.d % 8 != 0 || a.d > 64 || !rows_aligned(a.q, 16) ||
        !rows_aligned(a.k, 16) || !rows_aligned(a.v, 16) ||
        !rows_aligned(a.dout, 16) || !outs_ok)
      return cudaErrorInvalidValue;
    return static_cast<int>(launch_wgmma(dq_side, st, a, o0, o1));
  }
  if (is_bf16 && (!rows_aligned(a.q, 4) || !rows_aligned(a.k, 4) ||
                  !rows_aligned(a.v, 4) || !rows_aligned(a.dout, 4) ||
                  !rows_aligned(o0, 4) || (!dq_side && !rows_aligned(o1, 4))))
    return cudaErrorInvalidValue;
  const dim3 grid(a.batch * a.heads, (a.n + kBlock - 1) / kBlock);
  if (a.d <= 64)
    launch_sync_or_f32<64>(dq_side, is_bf16, grid, st, a.q, a.k, a.v, a.dout,
                           a.lse, a.delta, o0, o1, a.heads, a.n, a.d,
                           a.scale);
  else if (a.d <= 80)
    launch_sync_or_f32<80>(dq_side, is_bf16, grid, st, a.q, a.k, a.v, a.dout,
                           a.lse, a.delta, o0, o1, a.heads, a.n, a.d,
                           a.scale);
  else
    launch_sync_or_f32<128>(dq_side, is_bf16, grid, st, a.q, a.k, a.v,
                            a.dout, a.lse, a.delta, o0, o1, a.heads, a.n,
                            a.d, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each tensor is a pointer followed by its element strides over batch, head
// and token; lse and delta are contiguous [B*H, N] f32. Every entry returns
// a cudaError_t: cudaErrorInvalidValue for shapes or layouts its kernels do
// not take, else the launch's own status.
//
// flash_dq, flash_dkv: bf16 through the wgmma kernels (d a multiple of 8 up
// to 64, every row of the inputs and outputs 16-byte aligned), f32 through
// the FMA kernels.
extern "C" int flash_dq(const void* q, long long q_sb, long long q_sh,
                        long long q_sn, const void* k, long long k_sb,
                        long long k_sh, long long k_sn, const void* v,
                        long long v_sb, long long v_sh, long long v_sn,
                        const void* dout, long long do_sb, long long do_sh,
                        long long do_sn, void* dq, long long dq_sb,
                        long long dq_sh, long long dq_sn, const void* lse,
                        const void* delta, int batch, int heads, int n, int d,
                        int is_bf16, float scale, void* stream) {
  const Args a{{q, q_sb, q_sh, q_sn}, {k, k_sb, k_sh, k_sn},
               {v, v_sb, v_sh, v_sn}, {dout, do_sb, do_sh, do_sn},
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, heads, n, d, scale};
  return flash_bwd(true, false, a, {dq, dq_sb, dq_sh, dq_sn}, {}, is_bf16,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int flash_dkv(const void* q, long long q_sb, long long q_sh,
                         long long q_sn, const void* k, long long k_sb,
                         long long k_sh, long long k_sn, const void* v,
                         long long v_sb, long long v_sh, long long v_sn,
                         const void* dout, long long do_sb, long long do_sh,
                         long long do_sn, void* dk, long long dk_sb,
                         long long dk_sh, long long dk_sn, void* dv,
                         long long dv_sb, long long dv_sh, long long dv_sn,
                         const void* lse, const void* delta, int batch,
                         int heads, int n, int d, int is_bf16, float scale,
                         void* stream) {
  const Args a{{q, q_sb, q_sh, q_sn}, {k, k_sb, k_sh, k_sn},
               {v, v_sb, v_sh, v_sn}, {dout, do_sb, do_sh, do_sn},
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, heads, n, d, scale};
  return flash_bwd(false, false, a, {dk, dk_sb, dk_sh, dk_sn},
                   {dv, dv_sb, dv_sh, dv_sn}, is_bf16,
                   static_cast<cudaStream_t>(stream));
}

// flash_dq_narrow, flash_dkv_narrow: bf16 only (is_bf16 must be 1), through
// the mma.sync kernels, for any even d up to 128 with 4-byte aligned rows
// (the same arguments).
extern "C" int flash_dq_narrow(const void* q, long long q_sb, long long q_sh,
                               long long q_sn, const void* k, long long k_sb,
                               long long k_sh, long long k_sn, const void* v,
                               long long v_sb, long long v_sh, long long v_sn,
                               const void* dout, long long do_sb,
                               long long do_sh, long long do_sn, void* dq,
                               long long dq_sb, long long dq_sh,
                               long long dq_sn, const void* lse,
                               const void* delta, int batch, int heads, int n,
                               int d, int is_bf16, float scale, void* stream) {
  const Args a{{q, q_sb, q_sh, q_sn}, {k, k_sb, k_sh, k_sn},
               {v, v_sb, v_sh, v_sn}, {dout, do_sb, do_sh, do_sn},
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, heads, n, d, scale};
  return flash_bwd(true, true, a, {dq, dq_sb, dq_sh, dq_sn}, {}, is_bf16,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int flash_dkv_narrow(
    const void* q, long long q_sb, long long q_sh, long long q_sn,
    const void* k, long long k_sb, long long k_sh, long long k_sn,
    const void* v, long long v_sb, long long v_sh, long long v_sn,
    const void* dout, long long do_sb, long long do_sh, long long do_sn,
    void* dk, long long dk_sb, long long dk_sh, long long dk_sn, void* dv,
    long long dv_sb, long long dv_sh, long long dv_sn, const void* lse,
    const void* delta, int batch, int heads, int n, int d, int is_bf16,
    float scale, void* stream) {
  const Args a{{q, q_sb, q_sh, q_sn}, {k, k_sb, k_sh, k_sn},
               {v, v_sb, v_sh, v_sn}, {dout, do_sb, do_sh, do_sn},
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), batch, heads, n, d, scale};
  return flash_bwd(false, true, a, {dk, dk_sb, dk_sh, dk_sn},
                   {dv, dv_sb, dv_sh, dv_sn}, is_bf16,
                   static_cast<cudaStream_t>(stream));
}
