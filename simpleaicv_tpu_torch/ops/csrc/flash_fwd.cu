// Flash attention forward for Hopper (sm_90a). Replaces the Pallas kernel
// simpleaicv_tpu/ops/flash_attention.py::_fwd_kernel.
//
// For q, k, v [B, H, N, d] (any N) it computes
//   s   = d^-0.5 * q k^T
//   o   = softmax(s) v            (in q's dtype; p rounded to bf16 before p.v)
//   lse = rowmax + log(rowsum)    (f32, [B*H, N], natural log)
// with an online softmax over 64-key tiles, so the [N, N] scores never reach
// device memory. Keys past N score -inf and query rows past N are not
// written, which is what lets ViT's 197 tokens through.
//
// Bound: at ViT-B/16 batch 128 (BH 1536, N 197, d 64, bf16) one call does
// 4*N*N*d*BH = 15.3 GFLOP and moves 155 MB, so it is bound by bytes: 0.0466
// ms at 3.35 TB/s. q, k and v are read in place from the strided qkv
// projection and o is written in the [B, N, H, d] layout the output
// projection reads. The previous design (64 queries a block, so four
// blocks per head each read the head's K and V; 4-byte synchronous
// staging) took 0.3371 ms on an H100 at 700 W.
//
// bf16 blocks of 256 threads own 128 queries of one head, so at N 197 a
// head takes two blocks, side by side in the grid so that the second reads
// K and V from L2; 208 of their 256 query rows are real.
//   - d <= 64, 16-byte rows (flash_fwd_wgmma, the path's kernel): two
//     warpgroups of 64 rows. Thread 0 puts the key tiles of 64 keys into a
//     4-stage ring by TMA (K and V as 4-D tensor maps over (d, head,
//     token, batch) on the strided views, 128-byte swizzle, keys past N
//     read zero), so N <= 256 is in flight at once and a longer walk
//     refills the stage of tile u - 2; Q comes once by 16-byte cp.async.
//     S = Q K_u and O += P_{u-1} V_{u-1} run on wgmma (P from registers, V
//     MN-major through its descriptor), issued together, the warpgroups
//     taking turns, tile u's softmax beside the P V in flight; mbarriers
//     count the bytes in and the warps out. o is staged through the
//     warpgroup's rows of the Q tile and stored 16 bytes a thread.
//   - d 80 and 128, 16-byte rows (flash_fwd_bf16): 8 warps of 16 rows on
//     mma.sync.m16n8k16, Q and a 2-tile ring of 64-key tiles filled by
//     16-byte cp.async.cg copies into padded rows, fragments by
//     ldmatrix.x4 (.trans for V, read as stored), a key tile's 16-key
//     slices past N skipped and so are the products of a warp whose rows
//     all lie past N, o staged and stored 16 bytes a thread; one block an
//     SM (the accumulators of d 80 and 128 need the registers).
//   - Rows that are not 16-byte aligned (a pointer or a stride that is no
//     multiple of 8 elements, or d no multiple of 8; flash_fwd_narrow): the
//     mma.sync kernel with 4-byte copies and 4-byte stores.
// Every bf16 kernel takes the softmax in base 2 (one FMA per score folds
// d^-0.5 * log2 e into the exponent, ex2.approx) and writes lse as
// (m + log2 l) * ln 2, the natural log that the backward kernels read. The
// kernel is bound by bytes, yet the mma.sync version of the path's plan
// measured slower than the wgmma one (PERF.md): what holds a block back is
// its serial load, walk and store, not the tensor cores. The f32 kernel is
// a plain FMA loop kept for full-precision checks.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8):
// flash_fwd_wgmma 106 registers, no spills, 83,008 bytes of dynamic shared
// memory (two blocks an SM); the narrow d-64 variant 128 registers, no
// spills, 55,296 bytes.
//
// Plain C interface, loaded with ctypes; the caller passes PyTorch's current
// stream and element strides (unit stride over d).

#include "flash_mma.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;    // queries per block of the f32 kernel
constexpr int kTileQ = 128;    // queries per block of the bf16 kernel
constexpr int kTileK = 64;     // keys per shared-memory tile
constexpr int kThreads = 256;  // threads per block of the bf16 kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kStages = 2;     // key tiles in the ring

template <int D_PAD>
constexpr int smem_bytes() {
  return (kTileQ + 2 * kStages * kTileK) * (D_PAD + 8) * 2;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Lane (g = lane/4, t = lane%4) of warp w owns query rows 16w + g and
// 16w + g + 8 of the block's 128 and, in every 8-wide column tile, columns
// 2t and 2t+1. d is zero-padded to D_PAD (a multiple of 16).
template <int D_PAD, bool VEC>
__global__ void __launch_bounds__(kThreads, D_PAD <= 64 ? 2 : 1)
flash_fwd_bf16(View q, View k, View v, View o, float* __restrict__ lse,
               int heads, int n, int d, int q_tiles, float scale_log2) {
  constexpr int STR = D_PAD + 8;  // padded rows: conflict-free ldmatrix
  using L = Padded<STR>;
  constexpr int S = kStages;
  constexpr uint32_t kTile = kTileK * STR * 2;
  constexpr int NT = kTileK / 8;  // 8-wide key tiles per staged tile
  constexpr int DK = D_PAD / 16;  // 16-deep steps over d
  constexpr int DT = D_PAD / 8;   // 8-wide output tiles over d
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + kTileQ * STR * 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * kTileQ;
  const __nv_bfloat16* qh =
      head_ptr<__nv_bfloat16>(q, bh, heads) + (long long)q0 * q.sn;
  const __nv_bfloat16* kh = head_ptr<__nv_bfloat16>(k, bh, heads);
  const __nv_bfloat16* vh = head_ptr<__nv_bfloat16>(v, bh, heads);
  const int tiles = (n + kTileK - 1) / kTileK;
  // ldmatrix.x4 row addresses: lanes 8i..8i+7 address matrix i
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 8;

  load_tile<kTileQ, D_PAD, VEC, L, kThreads>(qs, qh, q.sn, n - q0, d, tid);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s < tiles) {
      const uint32_t ks = ring + s * 2 * kTile;
      load_tile<kTileK, D_PAD, VEC, L, kThreads>(
          ks, kh + (long long)s * kTileK * k.sn, k.sn, n - s * kTileK, d, tid);
      load_tile<kTileK, D_PAD, VEC, L, kThreads>(
          ks + kTile, vh + (long long)s * kTileK * v.sn, v.sn,
          n - s * kTileK, d, tid);
    }
    cp_async_commit();
  }

  const int r0 = warp * 16;
  const bool live = q0 + r0 < n;  // warp-uniform
  uint32_t qf[DK][4];
  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<S - 1>();
    __syncthreads();  // tile j (and, at j = 0, Q) has landed
    if (live) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          ldmatrix_x4(qf[kk], qs + L::offset(r0 + lm_row, kk * 16 + lm_col));
      }
      const int key0 = j * kTileK, kv = n - key0;
      const uint32_t ks = ring + (j % S) * 2 * kTile, vs = ks + kTile;

      float s[NT][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * np][e] = s[2 * np + 1][e] = 0.f;
        if (np * 16 < kv) {
#pragma unroll
          for (int kk = 0; kk < DK; ++kk) {
            uint32_t b[4];
            ldmatrix_x4(b, ks + L::offset(np * 16 + (lane / 16) * 8 + lane % 8,
                                          kk * 16 + (lane / 8 % 2) * 8));
            mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
        }
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = nt * 8 + 2 * t + e < kv;
          s[nt][e] = valid ? s[nt][e] : -INFINITY;
          s[nt][2 + e] = valid ? s[nt][2 + e] : -INFINITY;
          mx0 = fmaxf(mx0, s[nt][e]);
          mx1 = fmaxf(mx1, s[nt][2 + e]);
        }
      }
      // the row maximum in base-2 units (the scale is positive)
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      const float alpha0 = exp2_approx(m0 - mn0);
      const float alpha1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2_approx(fmaf(s[nt][e], scale_log2, -mn0));
          s[nt][2 + e] = exp2_approx(fmaf(s[nt][2 + e], scale_log2, -mn1));
          ls0 += s[nt][e];
          ls1 += s[nt][2 + e];
        }
      }
      l0 = l0 * alpha0 + ls0;  // per-lane partial sums; reduced at the end
      l1 = l1 * alpha1 + ls1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[dt][0] *= alpha0;
        oacc[dt][1] *= alpha0;
        oacc[dt][2] *= alpha1;
        oacc[dt][3] *= alpha1;
      }

      // o += p v, p rounded to bf16 as the A operand
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        if (kk * 16 < kv) {  // else the rest of the tile is padding
          uint32_t a[4];
          acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < D_PAD / 16; ++dp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, vs + L::offset(kk * 16 + lm_row,
                                                dp * 16 + lm_col));
            mma_bf16(oacc[2 * dp], a, b[0], b[1]);
            mma_bf16(oacc[2 * dp + 1], a, b[2], b[3]);
          }
        }
      }
    }
    if (j + S < tiles) {  // block-uniform
      __syncthreads();    // stage j % S is no longer read
      const uint32_t ks = ring + (j % S) * 2 * kTile;
      const int key0 = (j + S) * kTileK;
      load_tile<kTileK, D_PAD, VEC, L, kThreads>(
          ks, kh + (long long)key0 * k.sn, k.sn, n - key0, d, tid);
      load_tile<kTileK, D_PAD, VEC, L, kThreads>(
          ks + kTile, vh + (long long)key0 * v.sn, v.sn, n - key0, d, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (!live) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  __nv_bfloat16* oh = head_ptr<__nv_bfloat16>(o, bh, heads);
  if constexpr (VEC) {
    // through this warp's own rows of the Q tile, then 16 bytes a thread
    unsigned char* stage = smem + L::offset(r0, 0);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(stage + L::offset(g, c)) =
          __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(stage + L::offset(g + 8, c)) =
          __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
    }
    __syncwarp();
    const int chunks = d / 8;
    for (int i = lane; i < 16 * chunks; i += 32) {
      const int r = i / chunks, c = (i % chunks) * 8;
      if (q0 + r0 + r < n)
        *reinterpret_cast<uint4*>(oh + (long long)(q0 + r0 + r) * o.sn + c) =
            *reinterpret_cast<const uint4*>(stage + L::offset(r, c));
    }
  } else {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) {
        if (row0 < n)
          *reinterpret_cast<__nv_bfloat162*>(oh + row0 * o.sn + c) =
              __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
        if (row1 < n)
          *reinterpret_cast<__nv_bfloat162*>(oh + row1 * o.sn + c) =
              __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
      }
    }
  }
  if (t == 0) {
    if (row0 < n) lse[(size_t)bh * n + row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < n) lse[(size_t)bh * n + row1] = (m1 + log2f(l1)) * kLn2;
  }
}

// ------------------------- bf16, wgmma (the path) --------------------------

constexpr int kWgStages = 4;  // K/V tiles in the ring: N <= 256 at once
constexpr int kWgDPad = 64;   // the head width the wgmma kernel takes

constexpr int wg_smem_bytes() {
  return (kTileQ + 2 * kWgStages * kTileK) * kWgDPad * 2 + 1024 +
         2 * kWgStages * 8;
}

// Thread 0: key tile u of head (b, h) into ring stage ks by TMA, counted in
// on full (keys past N read zero).
__device__ __forceinline__ void tma_key_tile(uint32_t ks, uint32_t full,
                                             const CUtensorMap* k_map,
                                             const CUtensorMap* v_map,
                                             int b, int h, int u) {
  constexpr uint32_t kTile = kTileK * kWgDPad * 2;
  mbar_arrive_expect_tx(full, 2 * kTile);
  tma_load_4d(ks, k_map, 0, h, u * kTileK, b, full);
  tma_load_4d(ks + kTile, v_map, 0, h, u * kTileK, b, full);
}

// d <= 64 (the path's ViT-B/16): two warpgroups of 64 query rows with the
// structure of flash_relpos_fwd.cu's wgmma kernel without the bias: K and
// V tiles by TMA (128-byte swizzle) into a 4-stage ring, S = Q K_u (wgmma,
// Q from shared memory) and O += P_{u-1} V_{u-1} (P from registers, V
// MN-major) issued together, the warpgroups taking turns to issue.
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, View q, View o,
                float* __restrict__ lse, int heads, int n, int d,
                int q_tiles, float scale_log2) {
  constexpr int D_PAD = kWgDPad;
  using L = Core<D_PAD>;
  constexpr uint32_t kGroup = L::kGroupBytes;      // one 8-row group
  constexpr uint32_t kTile = kTileK * D_PAD * 2;   // one K or V stage
  constexpr int R = kTileK / 2;                    // S accumulators
  constexpr int RO = D_PAD / 2;                    // O accumulators
  constexpr int KS = kTileK / 16;                  // 16-key steps of P V
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = (qs + kTileQ * D_PAD * 2 + 1023) & ~1023u;
  const uint32_t full = ring + 2 * kWgStages * kTile;
  const uint32_t empty = full + kWgStages * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * kTileQ;
  const __nv_bfloat16* qh =
      head_ptr<__nv_bfloat16>(q, bh, heads) + (long long)q0 * q.sn;
  const int tiles = (n + kTileK - 1) / kTileK;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
  }
  const int b = bh / heads, h = bh % heads;
  load_tile<kTileQ, D_PAD, true, L, kThreads>(qs, qh, q.sn, n - q0, d, tid);
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
  // the first kWgStages key tiles go out before Q is waited for
  if (tid == 0) {
    for (int u = 0; u < kWgStages && u < tiles; ++u)
      tma_key_tile(ring + u * 2 * kTile, full + 8 * u, &k_map, &v_map, b, h,
                   u);
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q has landed

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16;  // this warp's first row
  const uint64_t desc_q = wgmma_desc(qs + wg * 8 * kGroup, 128, kGroup);
  float oacc[RO];
#pragma unroll
  for (int i = 0; i < RO; ++i) oacc[i] = 0.f;
  uint32_t p[KS][4];  // the previous tile's probabilities, bf16
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  if (wg == 1) named_bar_arrive(1, kThreads);
  for (int u = 0; u <= tiles; ++u) {
    const int s = u % kWgStages, prev = (u + kWgStages - 1) % kWgStages;
    float sacc[R];
    if (u < tiles) {
      mbar_wait(full + 8 * s, (u / kWgStages) & 1);
    }
    named_bar_sync(1 + wg, kThreads);
    wgmma_fence();
    if (u < tiles) {
      const uint64_t desc_k = wgmma_desc_sw128(ring + s * 2 * kTile);
      // 16 columns: 256 bytes of Q, 32 bytes of a swizzled row of K
#pragma unroll
      for (int kk = 0; kk < D_PAD / 16; ++kk)
        wgmma_ss<kTileK>(sacc, desc_q + 16 * kk, desc_k + 2 * kk, kk > 0);
    }
    wgmma_commit();
    if (u > 0) {
      const uint64_t desc_v =
          wgmma_desc_sw128(ring + prev * 2 * kTile + kTile);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)  // 16 rows = 2 groups of 1024 bytes
        wgmma_rs<D_PAD>(oacc, p[kk], desc_v + 128 * kk);
    }
    wgmma_commit();
    if (wg == 0 || u < tiles) named_bar_arrive(2 - wg, kThreads);
    if (u == tiles) {
      wgmma_wait<0>();
      fence_operands(oacc);
      break;
    }
    wgmma_wait<1>();  // S is ready; P V may still run
    fence_operands(sacc);

    const int kv = n - u * kTileK;  // live keys of this tile
    if (kv < kTileK) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (8 * (i / 4) + 2 * t + (i % 2) >= kv) sacc[i] = -INFINITY;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if ((i % 4) < 2)
        mx_a = fmaxf(mx_a, sacc[i]);
      else
        mx_b = fmaxf(mx_b, sacc[i]);
    }
    // the row maximum in base-2 units (the scale is positive)
    const float mn_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
    const float mn_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
    const float alpha_a = exp2_approx(m_a - mn_a);
    const float alpha_b = exp2_approx(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if ((i % 4) < 2) {
        sacc[i] = exp2_approx(fmaf(sacc[i], scale_log2, -mn_a));
        ls_a += sacc[i];
      } else {
        sacc[i] = exp2_approx(fmaf(sacc[i], scale_log2, -mn_b));
        ls_b += sacc[i];
      }
    }
    l_a = l_a * alpha_a + ls_a;  // per-lane partial sums; reduced at the end
    l_b = l_b * alpha_b + ls_b;
    if (tid == 0 && u + 2 >= kWgStages && u + 2 < tiles) {
      // past N = 256: tile u + 2 into the stage of tile u - 2, once both
      // warpgroups have read it
      const int s2 = (u + 2) % kWgStages;
      mbar_wait(empty + 8 * s2, ((u + 2) / kWgStages - 1) & 1);
      tma_key_tile(ring + s2 * 2 * kTile, full + 8 * s2, &k_map, &v_map, b,
                   h, u + 2);
    }
    wgmma_wait<0>();  // P_{u-1} V_{u-1} is done: its tile may be refilled
    fence_operands(oacc);
    if (u > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
    for (int i = 0; i < RO; ++i) oacc[i] *= (i % 4) < 2 ? alpha_a : alpha_b;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  // o through this warpgroup's rows of the Q tile (its products no longer
  // read them), then 16 bytes a thread
#pragma unroll
  for (int jj = 0; jj < D_PAD / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(smem + L::offset(r0 + g, c)) =
        __floats2bfloat162_rn(oacc[4 * jj] * inv_a, oacc[4 * jj + 1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(smem + L::offset(r0 + g + 8, c)) =
        __floats2bfloat162_rn(oacc[4 * jj + 2] * inv_b,
                              oacc[4 * jj + 3] * inv_b);
  }
  named_bar_sync(3 + wg, 128);
  __nv_bfloat16* oh = head_ptr<__nv_bfloat16>(o, bh, heads);
  const int chunks = d / 8, wt = tid % 128;
  for (int i = wt; i < 64 * chunks; i += 128) {
    const int r = wg * 64 + (i & 7) + ((i / (8 * chunks)) << 3);
    const int c = ((i >> 3) % chunks) * 8;
    if (q0 + r < n)
      *reinterpret_cast<uint4*>(oh + (long long)(q0 + r) * o.sn + c) =
          *reinterpret_cast<const uint4*>(smem + L::offset(r, c));
  }
  if (t == 0) {
    const int row_a = q0 + r0 + g, row_b = row_a + 8;
    if (row_a < n) lse[(size_t)bh * n + row_a] = (m_a + log2f(l_a)) * kLn2;
    if (row_b < n) lse[(size_t)bh * n + row_b] = (m_b + log2f(l_b)) * kLn2;
  }
}

// ---------------------------------- f32 ----------------------------------

// f32 kernel: one thread per query row, q and the accumulator in registers,
// keys staged 16 at a time in shared memory (read as broadcasts).
template <int D_PAD>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32(View q, View k, View v, View o, float* __restrict__ lse,
              int heads, int n, int d, float scale) {
  constexpr int SUB = 16;
  __shared__ float ks[SUB][D_PAD];
  __shared__ float vs[SUB][D_PAD];
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const bool ok = row < n;
  const float* qh = head_ptr<float>(q, bh, heads);
  const float* kh = head_ptr<float>(k, bh, heads);
  const float* vh = head_ptr<float>(v, bh, heads);

  float qr[D_PAD], acc[D_PAD];
#pragma unroll
  for (int i = 0; i < D_PAD; ++i) {
    qr[i] = (ok && i < d) ? qh[row * q.sn + i] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int key0 = 0; key0 < n; key0 += SUB) {
    const int cnt = min(SUB, n - key0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < SUB * D_PAD; idx += kBlockQ) {
      const int r = idx / D_PAD, c = idx % D_PAD;
      const bool in = r < cnt && c < d;
      ks[r][c] = in ? kh[(key0 + r) * k.sn + c] : 0.f;
      vs[r][c] = in ? vh[(key0 + r) * v.sn + c] : 0.f;
    }
    __syncthreads();
    float s[SUB];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D_PAD; ++i) dot = fmaf(qr[i], ks[r][i], dot);
      s[r] = (r < cnt) ? dot : -INFINITY;
      mx = fmaxf(mx, s[r]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < D_PAD; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < SUB; ++r) {
      const float p = expf(s[r] - mn);
      l += p;
#pragma unroll
      for (int i = 0; i < D_PAD; ++i) acc[i] = fmaf(p, vs[r][i], acc[i]);
    }
  }
  if (ok) {
    float* oh = head_ptr<float>(o, bh, heads);
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < D_PAD; ++i)
      if (i < d) oh[row * o.sn + i] = acc[i] * inv;
    lse[(size_t)bh * n + row] = m + logf(l);
  }
}

// The wgmma kernel, for d <= 64 with 16-byte rows: K and V as 4-D tensor
// maps (d, head, token, batch) in boxes of 64 x 1 x 64 x 1.
cudaError_t launch_wgmma(int batch, cudaStream_t st, View q, View k, View v,
                         View o, float* lse, int heads, int n, int d,
                         float scale) {
  CUtensorMap maps[2];
  const View* kv[2] = {&k, &v};
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                                (cuuint64_t)n, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)kv[i]->sh * 2,
                                   (cuuint64_t)kv[i]->sn * 2,
                                   (cuuint64_t)kv[i]->sb * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTileK, 1};
    const cudaError_t err =
        tensor_map_bf16(&maps[i], kv[i]->p, 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const int q_tiles = (n + kTileQ - 1) / kTileQ;
  constexpr int smem = wg_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<<<batch * heads * q_tiles, kThreads, smem, st>>>(
      maps[0], maps[1], q, o, lse, heads, n, d, q_tiles, scale * kLog2e);
  return cudaGetLastError();
}

template <int D_PAD, bool VEC>
cudaError_t launch_bf16(int bh, cudaStream_t st, View q, View k, View v,
                        View o, float* lse, int heads, int n, int d,
                        float scale) {
  const int q_tiles = (n + kTileQ - 1) / kTileQ;
  constexpr int smem = smem_bytes<D_PAD>();
  const auto kernel = flash_fwd_bf16<D_PAD, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<bh * q_tiles, kThreads, smem, st>>>(q, k, v, o, lse, heads, n, d,
                                               q_tiles, scale * kLog2e);
  return cudaGetLastError();
}

// The mma.sync kernel: with 16-byte copies for d 80 and 128 (d <= 64 takes
// the wgmma kernel), with 4-byte copies for any even d.
template <bool VEC>
cudaError_t launch_bf16_d(int bh, cudaStream_t st, View q, View k, View v,
                          View o, float* lse, int heads, int n, int d,
                          float scale) {
  if constexpr (!VEC) {
    if (d <= 64)
      return launch_bf16<64, false>(bh, st, q, k, v, o, lse, heads, n, d,
                                    scale);
  }
  if (d <= 80)
    return launch_bf16<80, VEC>(bh, st, q, k, v, o, lse, heads, n, d, scale);
  return launch_bf16<128, VEC>(bh, st, q, k, v, o, lse, heads, n, d, scale);
}

template <int D_PAD>
void launch_f32(dim3 grid, cudaStream_t st, View q, View k, View v, View o,
                float* lse, int heads, int n, int d, float scale) {
  flash_fwd_f32<D_PAD><<<grid, kBlockQ, 0, st>>>(q, k, v, o, lse, heads, n,
                                                 d, scale);
}

// Every row of the view starts on a multiple of `bytes` (pointer and
// strides, in elements of 2 bytes).
bool rows_aligned(const View& t, int bytes) {
  const long long e = bytes / 2;
  return reinterpret_cast<uintptr_t>(t.p) % bytes == 0 && t.sb % e == 0 &&
         t.sh % e == 0 && t.sn % e == 0;
}

bool shape_ok(int batch, int heads, int n, int d) {
  return batch >= 1 && heads >= 1 && n >= 1 && d >= 1 && d <= 128 &&
         (long long)batch * heads * ((n + kTileQ - 1) / kTileQ) < (1LL << 31);
}

}  // namespace

// Each tensor is a pointer followed by its element strides over batch, head
// and token. Both entries return a cudaError_t: cudaErrorInvalidValue for
// shapes or layouts the kernels do not take, else the launch's own status.
//
// flash_fwd: bf16 with 16-byte copies, which needs every row of q, k, v and
// o 16-byte aligned (pointers, and strides a multiple of 8 elements) and d a
// multiple of 8; f32 through the FMA kernel.
extern "C" int flash_fwd(const void* q, long long q_sb, long long q_sh,
                         long long q_sn, const void* k, long long k_sb,
                         long long k_sh, long long k_sn, const void* v,
                         long long v_sb, long long v_sh, long long v_sn,
                         void* o, long long o_sb, long long o_sh,
                         long long o_sn, void* lse, int batch, int heads,
                         int n, int d, int is_bf16, float scale,
                         void* stream) {
  if (!shape_ok(batch, heads, n, d) ||
      (!is_bf16 && (n + kBlockQ - 1) / kBlockQ > 65535))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv{q, q_sb, q_sh, q_sn}, kv{k, k_sb, k_sh, k_sn},
      vv{v, v_sb, v_sh, v_sn}, ov{o, o_sb, o_sh, o_sn};
  float* ls = static_cast<float*>(lse);
  if (is_bf16) {
    if (d % 8 != 0 || !rows_aligned(qv, 16) || !rows_aligned(kv, 16) ||
        !rows_aligned(vv, 16) || !rows_aligned(ov, 16))
      return cudaErrorInvalidValue;
    if (d <= kWgDPad)
      return static_cast<int>(
          launch_wgmma(batch, st, qv, kv, vv, ov, ls, heads, n, d, scale));
    return static_cast<int>(launch_bf16_d<true>(batch * heads, st, qv, kv, vv,
                                                ov, ls, heads, n, d, scale));
  }
  const dim3 grid(batch * heads, (n + kBlockQ - 1) / kBlockQ);
  if (d <= 64)
    launch_f32<64>(grid, st, qv, kv, vv, ov, ls, heads, n, d, scale);
  else if (d <= 80)
    launch_f32<80>(grid, st, qv, kv, vv, ov, ls, heads, n, d, scale);
  else
    launch_f32<128>(grid, st, qv, kv, vv, ov, ls, heads, n, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// flash_fwd_narrow: bf16 only (is_bf16 must be 1), with 4-byte copies, for
// rows that are 4-byte aligned and nothing more, and any even d.
extern "C" int flash_fwd_narrow(const void* q, long long q_sb, long long q_sh,
                                long long q_sn, const void* k, long long k_sb,
                                long long k_sh, long long k_sn, const void* v,
                                long long v_sb, long long v_sh, long long v_sn,
                                void* o, long long o_sb, long long o_sh,
                                long long o_sn, void* lse, int batch,
                                int heads, int n, int d, int is_bf16,
                                float scale, void* stream) {
  const View qv{q, q_sb, q_sh, q_sn}, kv{k, k_sb, k_sh, k_sn},
      vv{v, v_sb, v_sh, v_sn}, ov{o, o_sb, o_sh, o_sn};
  if (!shape_ok(batch, heads, n, d) || !is_bf16 || d % 2 != 0 ||
      !rows_aligned(qv, 4) || !rows_aligned(kv, 4) || !rows_aligned(vv, 4) ||
      !rows_aligned(ov, 4))
    return cudaErrorInvalidValue;
  return static_cast<int>(launch_bf16_d<false>(
      batch * heads, static_cast<cudaStream_t>(stream), qv, kv, vv, ov,
      static_cast<float*>(lse), heads, n, d, scale));
}
