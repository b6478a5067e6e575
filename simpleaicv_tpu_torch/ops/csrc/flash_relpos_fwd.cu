// Flash attention forward with SAM's decomposed relative-position bias, for
// Hopper (sm_90a). Replaces the Pallas kernel
// simpleaicv_tpu/ops/flash_attention.py::_relpos_fwd_kernel.
//
// For q, k, v [BH, N, d], rel_h [BH, N, k_h] f32, rel_w [BH, N, k_w] f32 and
// N = k_h * k_w it computes
//   s[i, j*k_w + c] = d^-0.5 * (q_i . k_{j*k_w+c}) + rel_h[i, j] + rel_w[i, c]
//   o   = softmax(s) v           (in q's dtype; p rounded to bf16 before p.v)
//   lse = rowmax + log(rowsum)   (f32, [BH, N], natural log)
// walking the key grid a few rows of k_w keys at a time with an online
// softmax, so the [N, N] bias and scores never reach device memory.
//
// Bound: at SAM-B's global layers (BH 12 for a served image, 96 for a
// training batch of 8; N 4096, d 64) one call does 4*N*N*d*BH = 51.5 GFLOP
// (BH 12) of matrix products and moves ~50 MB, so it is bound by the tensor
// cores: 0.0521 ms at 989 TFLOP/s. Its 4096 x 4096 exponentials a head
// take as long again on the special-function units (16 a cycle an SM), so
// the products and the softmax have to overlap to approach the bound. The
// previous design (mma.sync, 64 queries a block, 4-byte synchronous
// staging, V transposed by scalar stores) took 1.0671 ms at BH 12 and
// 7.1703 ms at BH 96 on an H100 at 700 W.
//
// bf16, the path's kernel (relpos_fwd_wgmma): a block owns 128 query rows
// as two consumer warpgroups of 64. A key tile is 128 keys (two key
// rows of k_w padded to KW_PAD; 64 keys where d > 64, for the registers),
// so rel_h adds one scalar per query row and key row, and rel_w's columns
// (scaled by log2 e, -inf past k_w) stay in registers for the whole walk.
//   - Loads: Q once by cp.async, then a ring of 4 K/V tiles in dynamic
//     shared memory. Where d pads to 64 (SAM's heads) a producer
//     warpgroup (registers moved to the consumers by setmaxnreg) has one
//     thread fill it by TMA, one box of KW_PAD keys x 64 columns with
//     128-byte swizzle per key row, K and V as 2-D tensor maps made with
//     cuTensorMapEncodeTiled, which the runtime's driver entry point
//     reaches (nothing links against libcuda); for other widths every
//     consumer thread issues its share of 16-byte cp.async.cg copies two
//     tiles ahead (zero-filled past k_w, k_h and d). An mbarrier per stage
//     counts the bytes or copies in and one counts the consumer warps out
//     once their products have read it, so no __syncthreads ties the walk.
//   - Products: S = Q K^T by wgmma.m64n128k16 (Q and K from shared memory,
//     K-major) and O += P V by wgmma.m64nD_PADk16 with P from registers as
//     bf16 (the accumulators of S are the A fragment) and V read MN-major
//     through its descriptor: no transposed copy. TMA's tiles carry the
//     128-byte swizzle; the copies write wgmma's layout without swizzle
//     (8x8 core matrices of 128 bytes, sm90_tiles.cuh), as does Q, which
//     both read without bank conflicts.
//   - Overlap: each iteration issues S for tile u and P V for tile u - 1
//     together and runs tile u's softmax while P V is in flight; the two
//     warpgroups take turns to issue (named barriers), so one's softmax
//     runs beside the other's products.
//   - Softmax in base 2: one FMA per score folds d^-0.5 * log2 e, rel_w is
//     pre-scaled, rel_h is added to each key row's maximum and offset;
//     ex2.approx; lse is written as (m + log2 l) * ln 2, the natural log
//     that K5 and K6 read.
// bf16 where q, k and v are not 16-byte aligned or d is no multiple of 8
// (relpos_fwd_sync, exported as flash_relpos_fwd_narrow): 8 warps of 16
// query rows walk the key rows with a 3-stage ring of 4-byte cp.async
// copies into padded row-major tiles, B fragments by ldmatrix.x4 (.trans
// for V) and both products on mma.sync.m16n8k16; one __syncthreads a key
// row.
// The f32 kernel is a plain FMA loop, kept for full-precision checks.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the
// path's relpos_fwd_wgmma<64, 64> 168 registers at entry (384 threads;
// setmaxnreg then gives each consumer thread 240 and the producer 24), no
// spills, 148,544 bytes of dynamic shared memory, one block an SM; the
// d-80 and d-128 variants 180 and 202 registers, no spills; the narrow
// kernel at <64, 64> 191 registers, no spills, 73,728 bytes.
//
// Plain C interface, loaded with ctypes; the caller passes contiguous
// tensors and PyTorch's current stream.

#include "flash_mma.cuh"
#include "sm90_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;    // queries per block of the f32 kernel
constexpr int kTileQ = 128;    // queries per block of the bf16 kernels
constexpr int kThreads = 256;  // threads per block of the bf16 kernels
constexpr int kStages = 3;     // K/V stages in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Bytes of dynamic shared memory of a bf16 kernel: Q and the K/V ring, each
// tile ROWS x COLS elements at a row stride of STR (COLS for Core tiles).
template <int STR, int KW_PAD>
constexpr int ring_bytes() {
  return (kTileQ + 2 * kStages * KW_PAD) * STR * 2;
}

// Issues the 4-byte copies of key row j (K and V) into ring stage
// j % kStages (the narrow kernel's).
template <int KW_PAD, int D_PAD, class Layout, int STR>
__device__ __forceinline__ void load_key_row(uint32_t ring,
                                             const __nv_bfloat16* k,
                                             const __nv_bfloat16* v,
                                             size_t base, int j, int k_w,
                                             int d, int tid) {
  constexpr uint32_t kTile = KW_PAD * STR * 2;
  const uint32_t ks = ring + (j % kStages) * 2 * kTile;
  const size_t key0 = base + (size_t)j * k_w * d;
  load_tile<KW_PAD, D_PAD, false, Layout, kThreads>(ks, k + key0, d, k_w,
                                                    d, tid);
  load_tile<KW_PAD, D_PAD, false, Layout, kThreads>(ks + kTile, v + key0,
                                                    d, k_w, d, tid);
}

// ------------------------- bf16, wgmma (the path) --------------------------

constexpr int kWsStages = 4;             // K/V tiles in the ring
constexpr int kWsAhead = kWsStages - 2;  // tiles in flight past the current

// Keys per tile of the wgmma kernel: 128 (two key rows of SAM's 64) where
// the registers allow, else 64.
template <int D_PAD>
constexpr int kTileKeys = D_PAD <= 64 ? 128 : 64;

// Q, 1024 bytes to align the ring (TMA's swizzled tiles), the ring, and
// the ring's mbarriers.
template <int D_PAD>
constexpr int ws_smem_bytes() {
  return (kTileQ + 2 * kWsStages * kTileKeys<D_PAD>) * D_PAD * 2 + 1024 +
         2 * kWsStages * 8;
}

// The ring is filled by TMA where d pads to 64 (one 128-byte swizzled row
// a key), by every thread's cp.async copies otherwise.
template <int D_PAD>
constexpr bool kByTma = D_PAD == 64;

template <int D_PAD, int KW_PAD>
using RowCopy = TileCopy16<KW_PAD, D_PAD, Core<D_PAD>, kThreads>;

// Issues this thread's share of the copies of key tile u (key rows u TR ..
// u TR + TR - 1, rows past k_h zero-filled) into ring stage ks, then one
// arrival on full once they have landed.
template <int D_PAD, int KW_PAD>
__device__ __forceinline__ void load_key_tile(
    const RowCopy<D_PAD, KW_PAD>& copy, uint32_t ks, uint32_t full,
    const __nv_bfloat16* k, const __nv_bfloat16* v, size_t base, int u,
    int k_h, int k_w, int d) {
  constexpr int TR = kTileKeys<D_PAD> / KW_PAD;
  constexpr uint32_t kTile = kTileKeys<D_PAD> * D_PAD * 2;
  constexpr uint32_t kRow = KW_PAD / 8 * Core<D_PAD>::kGroupBytes;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = u * TR + r;
    const int rows = row < k_h ? k_w : 0;
    const size_t key0 = base + (size_t)(row < k_h ? row : 0) * k_w * d;
    copy.issue(ks + r * kRow, k + key0, d, rows, d);
    copy.issue(ks + kTile + r * kRow, v + key0, d, rows, d);
  }
  cp_async_mbar_arrive(full);
}

template <int D_PAD, int KW_PAD>
__global__ void __launch_bounds__(kByTma<D_PAD> ? kThreads + 128 : kThreads,
                                  1)
relpos_fwd_wgmma(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ rel_h,
                 const float* __restrict__ rel_w,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int n, int d, int k_h, int k_w, float scale_log2) {
  using L = Core<D_PAD>;
  constexpr int TK = kTileKeys<D_PAD>;             // keys per tile
  constexpr int TR = TK / KW_PAD;                  // key rows per tile
  constexpr uint32_t kGroup = L::kGroupBytes;      // one 8-row group
  constexpr uint32_t kTile = TK * D_PAD * 2;       // one K or V stage
  constexpr int R = TK / 2;                        // S accumulators
  constexpr int RW = KW_PAD / 2;                   // rel_w registers
  constexpr int RO = D_PAD / 2;                    // O accumulators
  constexpr int KS = TK / 16;                      // 16-key steps of P V
  constexpr bool TMA = kByTma<D_PAD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = (qs + kTileQ * D_PAD * 2 + 1023) & ~1023u;
  // full[s]: TMA's bytes, or all 256 consumer threads once their copies of
  // a tile have landed; empty[s]: the 8 consumer warps, once their
  // products have read the tile
  const uint32_t full = ring + 2 * kWsStages * kTile;
  const uint32_t empty = full + kWsStages * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const size_t base = (size_t)bh * n * d;
  const int tiles = (k_h + TR - 1) / TR;

  if (tid == 0) {
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(full + 8 * s, TMA ? 1 : kThreads);
      mbar_init(empty + 8 * s, kThreads / 32);
    }
  }
  if (tid < kThreads)
    load_tile<kTileQ, D_PAD, true, L, kThreads>(
        qs, q + base + (size_t)q0 * d, d, n - q0, d, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // Q has landed; the barriers are initialised

  if (TMA && warp >= kThreads / 32) {
    // the producer warpgroup: one thread puts tile u into stage
    // u % kWsStages by TMA, once both warpgroups have released the tile
    // that stage held (key rows past k_h repeat the last one; their bias
    // is -inf)
    setmaxnreg_dec<24>();
    if (warp == kThreads / 32 && lane == 0) {
      for (int u = 0; u < tiles; ++u) {
        const int s = u % kWsStages;
        if (u >= kWsStages)
          mbar_wait(empty + 8 * s, (u / kWsStages - 1) & 1);
        const uint32_t ks = ring + s * 2 * kTile;
        mbar_arrive_expect_tx(full + 8 * s, 2 * kTile);
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int row = bh * n + min(u * TR + r, k_h - 1) * k_w;
          tma_load_2d(ks + r * KW_PAD * 128, &k_map, 0, row, full + 8 * s);
          tma_load_2d(ks + kTile + r * KW_PAD * 128, &v_map, 0, row,
                      full + 8 * s);
        }
      }
    }
  } else {
    if constexpr (TMA) setmaxnreg_inc<240>();
    // without TMA, kWsAhead tiles ahead: tile u + kWsAhead is issued after
    // tile u's softmax, into the stage of tile u - 2
    const RowCopy<D_PAD, KW_PAD> copy(tid);
    if constexpr (!TMA) {
      for (int u = 0; u < kWsAhead && u < tiles; ++u)
        load_key_tile<D_PAD, KW_PAD>(copy, ring + u * 2 * kTile, full + 8 * u,
                                     k, v, base, u, k_h, k_w, d);
    }

    // warpgroup wg owns query rows 64 wg .. 64 wg + 63
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int row_a = q0 + wg * 64 + (warp % 4) * 16 + g, row_b = row_a + 8;
    const bool ok_a = row_a < n, ok_b = row_b < n;

    // rel_w in base 2, -inf on the padded keys: this thread's columns of one
    // key row for its two query rows, for the whole walk; accumulator i
    // (column 8 (i / 4) + 2t + i % 2 of the tile) reads rw[i % RW]
    const float* rw_a = rel_w + ((size_t)bh * n + (ok_a ? row_a : 0)) * k_w;
    const float* rw_b = rel_w + ((size_t)bh * n + (ok_b ? row_b : 0)) * k_w;
    float rw[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i % 2);
      const float* p = (i % 4) < 2 ? rw_a : rw_b;
      rw[i] = c < k_w ? __ldg(p + c) * kLog2e : -INFINITY;
    }
    // rel_h of the next tile's key rows in base 2, -inf past k_h
    const float* rh_a = rel_h + ((size_t)bh * n + (ok_a ? row_a : 0)) * k_h;
    const float* rh_b = rel_h + ((size_t)bh * n + (ok_b ? row_b : 0)) * k_h;
    float rh_a_next[TR], rh_b_next[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      rh_a_next[r] = r < k_h ? __ldg(rh_a + r) * kLog2e : -INFINITY;
      rh_b_next[r] = r < k_h ? __ldg(rh_b + r) * kLog2e : -INFINITY;
    }

    const uint64_t desc_q = wgmma_desc(qs + wg * 8 * kGroup, 128, kGroup);
    float oacc[RO];
#pragma unroll
    for (int i = 0; i < RO; ++i) oacc[i] = 0.f;
    uint32_t p[KS][4];  // the previous tile's probabilities, bf16
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    // Each iteration issues S = Q K_u and O += P_{u-1} V_{u-1} together and
    // runs tile u's softmax while the second product is in flight. The two
    // warpgroups take turns to issue (named barriers 1 and 2, warpgroup 0
    // first), so that one's softmax runs beside the other's products.
    if (wg == 1) named_bar_arrive(1, kThreads);
    for (int u = 0; u <= tiles; ++u) {
      const int s = u % kWsStages, prev = (u + kWsStages - 1) % kWsStages;
      float sacc[R];
      if (u < tiles) {
#pragma unroll
        for (int i = 0; i < R; ++i) sacc[i] = 0.f;
        mbar_wait(full + 8 * s, (u / kWsStages) & 1);
        if constexpr (!TMA) fence_proxy_async();
      }
      named_bar_sync(1 + wg, kThreads);
      wgmma_fence();
      if (u < tiles) {
        const uint64_t desc_k =
            TMA ? wgmma_desc_sw128(ring + s * 2 * kTile)
                : wgmma_desc(ring + s * 2 * kTile, 128, kGroup);
        // 16 columns: 256 bytes of Q; 32 (swizzled) or 256 bytes of K
        constexpr int kStepK = TMA ? 2 : 16;
#pragma unroll
        for (int kk = 0; kk < D_PAD / 16; ++kk)
          wgmma_ss<TK>(sacc, desc_q + 16 * kk, desc_k + kStepK * kk, kk > 0);
      }
      wgmma_commit();
      if (u > 0) {
        const uint64_t desc_v =
            TMA ? wgmma_desc_sw128(ring + prev * 2 * kTile + kTile)
                : wgmma_desc(ring + prev * 2 * kTile + kTile, kGroup, 128);
        // 16 rows = 2 groups of 1024 (swizzled) or D_PAD * 16 bytes
        constexpr int kStepV = (TMA ? 2048 : 2 * kGroup) / 16;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs<D_PAD>(oacc, p[kk], desc_v + kStepV * kk);
      }
      wgmma_commit();
      if (wg == 0 || u < tiles) named_bar_arrive(2 - wg, kThreads);
      if (u == tiles) {
        wgmma_wait<0>();
        fence_operands(oacc);
        break;
      }
      float bias_a[TR], bias_b[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        bias_a[r] = rh_a_next[r];
        bias_b[r] = rh_b_next[r];
        const int row = (u + 1) * TR + r;
        if (row < k_h) {
          rh_a_next[r] = __ldg(rh_a + row) * kLog2e;
          rh_b_next[r] = __ldg(rh_b + row) * kLog2e;
        } else {
          rh_a_next[r] = rh_b_next[r] = -INFINITY;
        }
      }
      wgmma_wait<1>();  // S is ready; P V may still run
      fence_operands(sacc);

      // s in base 2 without rel_h, which is folded into each key row's
      // maximum and offset
      float mx_a[TR], mx_b[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) mx_a[r] = mx_b[r] = -INFINITY;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = (i / 4) / (KW_PAD / 8);  // key row within the tile
        sacc[i] = fmaf(sacc[i], scale_log2, rw[i % RW]);
        if ((i % 4) < 2)
          mx_a[r] = fmaxf(mx_a[r], sacc[i]);
        else
          mx_b[r] = fmaxf(mx_b[r], sacc[i]);
      }
      float mn_a = m_a, mn_b = m_b;
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        mn_a = fmaxf(mn_a, mx_a[r] + bias_a[r]);
        mn_b = fmaxf(mn_b, mx_b[r] + bias_b[r]);
      }
      mn_a = quad_max(mn_a);
      mn_b = quad_max(mn_b);
      const float alpha_a = exp2_approx(m_a - mn_a);
      const float alpha_b = exp2_approx(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = (i / 4) / (KW_PAD / 8);
        if ((i % 4) < 2) {
          sacc[i] = exp2_approx(sacc[i] - (mn_a - bias_a[r]));
          ls_a += sacc[i];
        } else {
          sacc[i] = exp2_approx(sacc[i] - (mn_b - bias_b[r]));
          ls_b += sacc[i];
        }
      }
      l_a = l_a * alpha_a + ls_a;  // per-lane partial sums; reduced at the end
      l_b = l_b * alpha_b + ls_b;

      if (!TMA && u + kWsAhead < tiles) {
        // tile u + kWsAhead into the stage of tile u - 2, once both
        // warpgroups have read it
        const int un = u + kWsAhead, s2 = un % kWsStages;
        if (un >= kWsStages)
          mbar_wait(empty + 8 * s2, (un / kWsStages - 1) & 1);
        load_key_tile<D_PAD, KW_PAD>(copy, ring + s2 * 2 * kTile, full + 8 * s2,
                                     k, v, base, un, k_h, k_w, d);
      }
      wgmma_wait<0>();  // P_{u-1} V_{u-1} is done: its tile may be refilled
      fence_operands(oacc);
      if (u > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int i = 0; i < RO; ++i) oacc[i] *= (i % 4) < 2 ? alpha_a : alpha_b;
      // the accumulators of key columns 16kk..16kk+15, in bf16, are the A
      // fragment of one 16-deep step of P V
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
#pragma unroll
    for (int jj = 0; jj < D_PAD / 8; ++jj) {
      const int c = 8 * jj + 2 * t;
      if (c < d) {
        if (ok_a)
          *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row_a * d + c) =
              __floats2bfloat162_rn(oacc[4 * jj] * inv_a,
                                    oacc[4 * jj + 1] * inv_a);
        if (ok_b)
          *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row_b * d + c) =
              __floats2bfloat162_rn(oacc[4 * jj + 2] * inv_b,
                                    oacc[4 * jj + 3] * inv_b);
      }
    }
    if (t == 0) {
      if (ok_a) lse[(size_t)bh * n + row_a] = (m_a + log2f(l_a)) * kLn2;
      if (ok_b) lse[(size_t)bh * n + row_b] = (m_b + log2f(l_b)) * kLn2;
    }
  }
}

// ----------------- bf16, mma.sync (unaligned inputs, any even d) -----------

// Lane (g, t) of warp w owns query rows 16w + g and 16w + g + 8 of the
// block's 128 and, in every 8-wide column tile, columns 2t and 2t + 1.
template <int D_PAD, int KW_PAD>
__global__ void __launch_bounds__(kThreads)
relpos_fwd_sync(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ rel_h,
                const float* __restrict__ rel_w,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int n,
                int d, int k_h, int k_w, float scale_log2) {
  constexpr int STR = D_PAD + 8;
  using L = Padded<STR>;
  constexpr uint32_t kTile = KW_PAD * STR * 2;
  constexpr int NT = KW_PAD / 8;  // 8-wide key tiles per key row
  constexpr int DK = D_PAD / 16;  // 16-deep steps over d
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ring = qs + kTileQ * STR * 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTileQ;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const bool ok_a = row_a < n, ok_b = row_b < n;
  const size_t base = (size_t)bh * n * d;
  // ldmatrix.x4 row addresses: lanes 8i..8i+7 address matrix i
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 8;

  load_tile<kTileQ, D_PAD, false, L, kThreads>(
      qs, q + base + (size_t)q0 * d, d, n - q0, d, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_h)
      load_key_row<KW_PAD, D_PAD, L, STR>(ring, k, v, base, s, k_w, d, tid);
    cp_async_commit();
  }

  const float* rw_a = rel_w + ((size_t)bh * n + (ok_a ? row_a : 0)) * k_w;
  const float* rw_b = rel_w + ((size_t)bh * n + (ok_b ? row_b : 0)) * k_w;
  float rw[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * t + e;
      rw[nt][e] = c < k_w ? __ldg(rw_a + c) * kLog2e : -INFINITY;
      rw[nt][2 + e] = c < k_w ? __ldg(rw_b + c) * kLog2e : -INFINITY;
    }
  }
  const float* rh_a = rel_h + ((size_t)bh * n + (ok_a ? row_a : 0)) * k_h;
  const float* rh_b = rel_h + ((size_t)bh * n + (ok_b ? row_b : 0)) * k_h;
  float rh_next_a = __ldg(rh_a), rh_next_b = __ldg(rh_b);

  uint32_t qf[DK][4];
  float oacc[D_PAD / 8][4];
#pragma unroll
  for (int dt = 0; dt < D_PAD / 8; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < k_h; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // key row j has landed; row j - 1 is no longer read
    if (j + kStages - 1 < k_h)
      load_key_row<KW_PAD, D_PAD, L, STR>(ring, k, v, base, j + kStages - 1,
                                          k_w, d, tid);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldmatrix_x4(qf[kk], qs + L::offset(warp * 16 + lm_row,
                                           kk * 16 + lm_col));
    }
    const float bias_a = rh_next_a * kLog2e, bias_b = rh_next_b * kLog2e;
    if (j + 1 < k_h) {
      rh_next_a = __ldg(rh_a + j + 1);
      rh_next_b = __ldg(rh_b + j + 1);
    }
    const uint32_t ks = ring + (j % kStages) * 2 * kTile, vs = ks + kTile;

    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two key tiles
    float s[NT][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      s[2 * np][0] = s[2 * np][1] = s[2 * np][2] = s[2 * np][3] = 0.f;
      s[2 * np + 1][0] = s[2 * np + 1][1] = s[2 * np + 1][2] =
          s[2 * np + 1][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + L::offset(np * 16 + (lane / 16) * 8 + lane % 8,
                                      kk * 16 + (lane / 8 % 2) * 8));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = fmaf(s[nt][e], scale_log2, rw[nt][e]);
        s[nt][2 + e] = fmaf(s[nt][2 + e], scale_log2, rw[nt][2 + e]);
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a) + bias_a);
    const float mn_b = fmaxf(m_b, quad_max(mx_b) + bias_b);
    const float alpha_a = exp2_approx(m_a - mn_a);
    const float alpha_b = exp2_approx(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    const float off_a = mn_a - bias_a, off_b = mn_b - bias_b;
    float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2_approx(s[nt][e] - off_a);
        s[nt][2 + e] = exp2_approx(s[nt][2 + e] - off_b);
        ls_a += s[nt][e];
        ls_b += s[nt][2 + e];
      }
    }
    l_a = l_a * alpha_a + ls_a;
    l_b = l_b * alpha_b + ls_b;
#pragma unroll
    for (int dt = 0; dt < D_PAD / 8; ++dt) {
      oacc[dt][0] *= alpha_a;
      oacc[dt][1] *= alpha_a;
      oacc[dt][2] *= alpha_b;
      oacc[dt][3] *= alpha_b;
    }

    // O += P V: ldmatrix.x4.trans reads V as stored (keys down the rows)
#pragma unroll
    for (int kk = 0; kk < KW_PAD / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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
  cp_async_wait<0>();

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int dt = 0; dt < D_PAD / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c < d) {
      if (ok_a)
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row_a * d + c) =
            __floats2bfloat162_rn(oacc[dt][0] * inv_a, oacc[dt][1] * inv_a);
      if (ok_b)
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row_b * d + c) =
            __floats2bfloat162_rn(oacc[dt][2] * inv_b, oacc[dt][3] * inv_b);
    }
  }
  if (t == 0) {
    if (ok_a) lse[(size_t)bh * n + row_a] = (m_a + log2f(l_a)) * kLn2;
    if (ok_b) lse[(size_t)bh * n + row_b] = (m_b + log2f(l_b)) * kLn2;
  }
}

// ---------------------------------- f32 ----------------------------------

// f32 kernel: one thread per query row, q and the accumulator in registers,
// keys staged 16 at a time in shared memory (read as broadcasts).
template <int D_PAD>
__global__ void __launch_bounds__(kBlockQ)
relpos_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ rel_h,
               const float* __restrict__ rel_w, float* __restrict__ o,
               float* __restrict__ lse, int n, int d, int k_h, int k_w,
               float scale) {
  constexpr int SUB = 16;
  __shared__ float ks[SUB][D_PAD];
  __shared__ float vs[SUB][D_PAD];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool ok = row < n;
  const size_t base = (size_t)bh * n * d;

  float qr[D_PAD], acc[D_PAD];
#pragma unroll
  for (int i = 0; i < D_PAD; ++i) {
    qr[i] = (ok && i < d) ? q[base + (size_t)row * d + i] * scale : 0.f;
    acc[i] = 0.f;
  }
  const float* rh = rel_h + ((size_t)bh * n + (ok ? row : 0)) * k_h;
  const float* rw = rel_w + ((size_t)bh * n + (ok ? row : 0)) * k_w;
  float m = -INFINITY, l = 0.f;

  for (int j = 0; j < k_h; ++j) {
    const float bias_h = ok ? rh[j] : 0.f;
    for (int c0 = 0; c0 < k_w; c0 += SUB) {
      const int cnt = min(SUB, k_w - c0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < SUB * D_PAD; idx += kBlockQ) {
        const int r = idx / D_PAD, c = idx % D_PAD;
        float kv = 0.f, vv = 0.f;
        if (r < cnt && c < d) {
          const size_t off = base + (size_t)(j * k_w + c0 + r) * d + c;
          kv = k[off];
          vv = v[off];
        }
        ks[r][c] = kv;
        vs[r][c] = vv;
      }
      __syncthreads();
      float s[SUB];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < SUB; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < D_PAD; ++i) dot = fmaf(qr[i], ks[r][i], dot);
        s[r] = (r < cnt) ? dot + bias_h + (ok ? rw[c0 + r] : 0.f) : -INFINITY;
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
  }
  if (ok) {
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < D_PAD; ++i)
      if (i < d) o[base + (size_t)row * d + i] = acc[i] * inv;
    lse[(size_t)bh * n + row] = m + logf(l);
  }
}

template <int D_PAD>
void launch_f32(dim3 grid, cudaStream_t st, const void* q, const void* k,
                const void* v, const float* rh, const float* rw, void* o,
                float* lse, int n, int d, int k_h, int k_w, float scale) {
  relpos_fwd_f32<D_PAD><<<grid, kBlockQ, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), rh, rw, static_cast<float*>(o), lse, n, d,
      k_h, k_w, scale);
}


// The tensor map of a [rows, d] bf16 matrix (d a multiple of 8, the base
// 16-byte aligned) read in boxes of box_rows rows x 64 columns with 128-byte
// swizzle; columns past d read zero.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int d,
                       long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return tensor_map_bf16(map, base, 2, dims, strides, box);
}

template <class Kernel, class... Maps>
cudaError_t launch(Kernel kernel, int smem, int threads, dim3 grid,
                   cudaStream_t st, const void* q, const void* k,
                   const void* v, const float* rh, const float* rw, void* o,
                   float* lse, int n, int d, int k_h, int k_w,
                   float scale_log2, const Maps&... maps) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(
      maps..., static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rh, rw,
      static_cast<__nv_bfloat16*>(o), lse, n, d, k_h, k_w, scale_log2);
  return cudaGetLastError();
}

template <int D_PAD, int KW_PAD>
cudaError_t launch_bf16(bool wide, dim3 grid, cudaStream_t st, const void* q,
                        const void* k, const void* v, const float* rh,
                        const float* rw, void* o, float* lse, int n, int d,
                        int k_h, int k_w, float scale_log2) {
  if (wide) {
    CUtensorMap k_map{}, v_map{};
    if (kByTma<D_PAD>) {
      const long long rows = (long long)grid.y * n;
      cudaError_t err = tensor_map(&k_map, k, d, rows, KW_PAD);
      if (err == cudaSuccess) err = tensor_map(&v_map, v, d, rows, KW_PAD);
      if (err != cudaSuccess) return err;
    }
    return launch(relpos_fwd_wgmma<D_PAD, KW_PAD>, ws_smem_bytes<D_PAD>(),
                  kByTma<D_PAD> ? kThreads + 128 : kThreads, grid, st, q, k,
                  v, rh, rw, o, lse, n, d, k_h, k_w, scale_log2, k_map,
                  v_map);
  }
  return launch(relpos_fwd_sync<D_PAD, KW_PAD>,
                ring_bytes<D_PAD + 8, KW_PAD>(), kThreads, grid, st, q, k, v,
                rh, rw, o, lse, n, d, k_h, k_w, scale_log2);
}

template <int D_PAD>
cudaError_t launch_bf16_kw(bool wide, dim3 grid, cudaStream_t st,
                           const void* q, const void* k, const void* v,
                           const float* rh, const float* rw, void* o,
                           float* lse, int n, int d, int k_h, int k_w,
                           float scale_log2) {
  if (k_w <= 16)
    return launch_bf16<D_PAD, 16>(wide, grid, st, q, k, v, rh, rw, o, lse, n,
                                  d, k_h, k_w, scale_log2);
  if (k_w <= 32)
    return launch_bf16<D_PAD, 32>(wide, grid, st, q, k, v, rh, rw, o, lse, n,
                                  d, k_h, k_w, scale_log2);
  return launch_bf16<D_PAD, 64>(wide, grid, st, q, k, v, rh, rw, o, lse, n,
                                d, k_h, k_w, scale_log2);
}

bool shape_ok(int bh, int n, int d, int k_h, int k_w) {
  return bh >= 1 && bh <= 65535 && k_h >= 1 && k_w >= 1 && k_w <= 64 &&
         k_h * k_w == n && d >= 2 && d <= 128 && d % 2 == 0;
}

int relpos_fwd(bool wide, const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, void* o, void* lse,
               int bh, int n, int d, int k_h, int k_w, float scale,
               void* stream) {
  const dim3 grid((n + kTileQ - 1) / kTileQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  float* ls = static_cast<float*>(lse);
  const float sl = scale * kLog2e;
  cudaError_t err;
  if (d <= 32)
    err = launch_bf16_kw<32>(wide, grid, st, q, k, v, rh, rw, o, ls, n, d,
                             k_h, k_w, sl);
  else if (d <= 64)
    err = launch_bf16_kw<64>(wide, grid, st, q, k, v, rh, rw, o, ls, n, d,
                             k_h, k_w, sl);
  else if (d <= 80)
    err = launch_bf16_kw<80>(wide, grid, st, q, k, v, rh, rw, o, ls, n, d,
                             k_h, k_w, sl);
  else
    err = launch_bf16_kw<128>(wide, grid, st, q, k, v, rh, rw, o, ls, n, d,
                              k_h, k_w, sl);
  return static_cast<int>(err);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Both entries return a cudaError_t: cudaErrorInvalidValue for shapes or
// pointers the kernels do not take, else the launch's own status.
//
// flash_relpos_fwd: bf16 through the wgmma kernel, which copies 16 bytes a
// thread and so needs q, k and v 16-byte aligned and d a multiple of 8;
// f32 through the FMA kernel.
extern "C" int flash_relpos_fwd(const void* q, const void* k, const void* v,
                                const void* rel_h, const void* rel_w, void* o,
                                void* lse, int bh, int n, int d, int k_h,
                                int k_w, int is_bf16, float scale,
                                void* stream) {
  if (!shape_ok(bh, n, d, k_h, k_w)) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (d % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v))
      return cudaErrorInvalidValue;
    return relpos_fwd(true, q, k, v, rel_h, rel_w, o, lse, bh, n, d, k_h, k_w,
                      scale, stream);
  }
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  float* ls = static_cast<float*>(lse);
  if (d <= 32)
    launch_f32<32>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
  else if (d <= 64)
    launch_f32<64>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
  else if (d <= 80)
    launch_f32<80>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
  else
    launch_f32<128>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
  return static_cast<int>(cudaGetLastError());
}

// flash_relpos_fwd_narrow: bf16 only, through the mma.sync kernel with
// 4-byte copies, for inputs that are 4-byte aligned and nothing more (the
// same arguments; is_bf16 must be 1).
extern "C" int flash_relpos_fwd_narrow(const void* q, const void* k,
                                       const void* v, const void* rel_h,
                                       const void* rel_w, void* o, void* lse,
                                       int bh, int n, int d, int k_h, int k_w,
                                       int is_bf16, float scale,
                                       void* stream) {
  if (!shape_ok(bh, n, d, k_h, k_w) || !is_bf16)
    return cudaErrorInvalidValue;
  return relpos_fwd(false, q, k, v, rel_h, rel_w, o, lse, bh, n, d, k_h, k_w,
                    scale, stream);
}
