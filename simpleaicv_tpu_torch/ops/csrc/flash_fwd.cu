// Flash attention forward for Hopper (sm_90a), K1. Replaces the Pallas
// kernel simpleaicv_tpu/ops/flash_attention.py::_fwd_kernel.
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
// projection reads. Earlier designs on an H100 at 700 W: 64-query blocks
// with 4-byte synchronous staging 0.3371 ms; a wgmma kernel of 3072 blocks
// of two warpgroups, each loading Q, walking its head's K and V and storing
// o in sequence, two blocks an SM, 0.1351 ms, 1.5 times SDPA's forward.
//
// bf16, d <= 64 with 16-byte rows (flash_fwd_tma, the path's kernel): a
// persistent kernel on the plan of flash_bwd.cu's K2 and K3. A grid of one
// block an SM walks (head, 256-row tile) items in a fixed order
// (flash_items.cuh), so every launch gives the same bits; at N <= 256 an
// item is a whole head, so its K and V pass through shared memory once.
//   - A producer warpgroup gives its registers to four consumer warpgroups
//     (setmaxnreg, 24 and 112 a thread); one thread loads each item's Q by
//     TMA into one of two slots (4-D tensor maps over (d, head, token,
//     batch) on the strided views, 128-byte swizzle, rows past N read
//     zero), so item i + 1's Q arrives while item i runs, and K and V
//     through a 6-stage ring of 64-key tiles that runs on across items
//     (its mbarrier parities carry over).
//   - Consumer warpgroup w owns the item's rows 64w .. 64w + 63. It walks
//     the block's items as one stream of key tiles: step v issues S = Q K^T
//     of tile v and O += P V of tile v - 1 (P from registers, V read
//     MN-major) and computes tile v's softmax while the latter is in
//     flight; at an item's first step the P V product completes the
//     previous item. Every product is issued on every step (the last
//     step's scores read a stale stage and are not used): ptxas serialises
//     all of a kernel's products when one sits under a condition. The
//     warpgroups issue independently: taking turns, as K2 and K3 do,
//     measured slower here, and four warpgroups of one 64-row tile beat two
//     of two (ptxas serialised the products at 104 registers a thread, not
//     at 112).
//   - o is rounded to bf16 into the finished item's Q slot and stored from
//     there by TMA (rows past N are not written), one thread of each
//     warpgroup issuing, while the next item's products run; the slot is
//     released once the stores have read it. lse is written with plain
//     stores.
// bf16 otherwise (chosen by ops/flash_attention.py::_flash_fwd_variant):
//   - d 80 and 128 with 16-byte rows (flash_fwd_bf16, "wide_sync"): 8 warps
//     of 16 rows on mma.sync.m16n8k16, Q and a 2-tile ring of 64-key tiles
//     filled by 16-byte cp.async.cg copies into padded rows, fragments by
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
// f32 kernel is a plain FMA loop kept for full-precision checks.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, CUDA 12.8):
// flash_fwd_tma 96 registers at entry (640 threads; setmaxnreg then gives
// each consumer thread 112 and the producer 24), no spills, 164,992 bytes
// of dynamic shared memory, no ptxas note C75xx; the narrow d-64 variant
// 128 registers, no spills.
//
// Plain C interface, loaded with ctypes; the caller passes PyTorch's current
// stream and element strides (unit stride over d).

#include "flash_items.cuh"

namespace {

constexpr int kBlockQ = 64;    // queries per block of the f32 kernel
constexpr int kTileQ = 128;    // queries per block of the bf16 kernel
constexpr int kTileK = 64;     // keys per shared-memory tile
constexpr int kThreads = 256;  // threads per block of the bf16 kernel
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

// ---------------- bf16, persistent wgmma + TMA (the path) -----------------

constexpr int kConsumers = 512;               // four consumer warpgroups
constexpr int kWsThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kItemRows = 256;                // an item: 4 tiles of 64 rows
// 64-row tiles of an item a consumer warpgroup owns
constexpr int kTiles = kItemRows / 64 / (kConsumers / 128);
// registers of a producer and a consumer thread after setmaxnreg: the
// producer's release (from the 96 a thread of 640 starts with) covers the
// consumers' growth
constexpr int kProducerRegs = 24, kConsumerRegs = 112;
constexpr int kRing = 6;                      // K/V stages of the ring
constexpr uint32_t kQSlot = 4 * kBox;         // an item's Q, [256][64]
// 1024 bytes to align the swizzled tiles, two Q slots, the ring of K/V
// stages and the mbarriers
constexpr int kTmaSmem =
    1024 + 2 * kQSlot + kRing * 2 * kBox + (2 * kRing + 4) * 8;

// The online softmax of one 64-key tile in place of its scores: keys from
// kv on score -inf; m and l of the thread's rows a (accumulators i % 4 < 2)
// and b are the running maximum in base-2 units and the per-lane partial
// row sum. Returns the factors by which the rows' earlier output shrinks.
__device__ __forceinline__ float2 softmax_tile(float (&s)[32], int kv,
                                               int t, float scale_log2,
                                               float2& m, float2& l) {
  if (kv < 64) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i / 4) + 2 * t + (i % 2) >= kv) s[i] = -INFINITY;
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((i % 4) < 2)
      mx_a = fmaxf(mx_a, s[i]);
    else
      mx_b = fmaxf(mx_b, s[i]);
  }
  // the row maximum in base-2 units (the scale is positive)
  const float mn_a = fmaxf(m.x, quad_max(mx_a) * scale_log2);
  const float mn_b = fmaxf(m.y, quad_max(mx_b) * scale_log2);
  const float2 alpha = make_float2(exp2_approx(m.x - mn_a),
                                   exp2_approx(m.y - mn_b));
  m = make_float2(mn_a, mn_b);
  float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((i % 4) < 2) {
      s[i] = exp2_approx(fmaf(s[i], scale_log2, -mn_a));
      ls_a += s[i];
    } else {
      s[i] = exp2_approx(fmaf(s[i], scale_log2, -mn_b));
      ls_b += s[i];
    }
  }
  l = make_float2(l.x * alpha.x + ls_a, l.y * alpha.y + ls_b);
  return alpha;
}

// o and lse for the items of this block (d <= 64, ViT-B/16's layers). An
// item is 256 rows of a head, all of it at N <= 256, so that the head's K
// and V pass through shared memory once. Warpgroup wg owns the item's
// 64-row tiles kTiles wg + r (r < kTiles); warp w of it holds rows 16w + g
// and 16w + g + 8 (a and b) of each, and accumulator i of a tile is column
// 8 (i / 4) + 2t + i % 2 of row a (i % 4 < 2) or b.
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_tma(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap o_map,
              float* __restrict__ lse, int batch, int heads, int n,
              float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t slots = (s0 + 1023) & ~1023u;  // slot x: an item's Q
  const uint32_t ring = slots + 2 * kQSlot;     // stage s: K, then V
  // full[s]: TMA's bytes; empty[s]: the 8 consumer warps, once their
  // products have read the stage; q_full[x], q_empty[x]: the same for slot
  // x, which also stages the item's o on its way out
  const uint32_t full = ring + kRing * 2 * kBox;
  const uint32_t empty = full + kRing * 8;
  const uint32_t q_full = empty + kRing * 8;
  const uint32_t q_empty = q_full + 2 * 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Walk walk(batch * heads, n, kItemRows);
  const int count = walk.count();

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + 8 * x, 1);
      mbar_init(q_empty + 8 * x, kConsumers / 32);
    }
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer: one thread loads item i's Q into slot i % 2 once the
    // consumers have stored item i - 2's o from it, then the head's key
    // tiles into the ring, tile g (counted over the block's walk) into
    // stage g % kRing
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      int g = 0;
      for (int i = 0; i < count; ++i) {
        const int item = blockIdx.x + i * gridDim.x;
        const int bh = item / walk.row_tiles;
        const int b = bh / heads, h = bh % heads;
        const int x = i & 1;
        if (i >= 2) mbar_wait(q_empty + 8 * x, ((i >> 1) - 1) & 1);
        mbar_arrive_expect_tx(q_full + 8 * x, kQSlot);
        const int r0 = (item % walk.row_tiles) * kItemRows;
        tma_load_4d(slots + x * kQSlot, &q_map, 0, h, r0, b, q_full + 8 * x);
        tma_load_4d(slots + x * kQSlot + 2 * kBox, &q_map, 0, h, r0 + kRows,
                    b, q_full + 8 * x);
        for (int u = 0; u < walk.tiles; ++u, ++g) {
          const int s = g % kRing;
          if (g >= kRing) mbar_wait(empty + 8 * s, (g / kRing - 1) & 1);
          const uint32_t ks = ring + s * 2 * kBox;
          mbar_arrive_expect_tx(full + 8 * s, 2 * kBox);
          tma_load_4d(ks, &k_map, 0, h, u * 64, b, full + 8 * s);
          tma_load_4d(ks + kBox, &v_map, 0, h, u * 64, b, full + 8 * s);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int tiles = walk.tiles, steps = count * tiles;
  float oacc[kTiles][32];
  uint32_t pf[kTiles][4][4] = {};  // the previous key tile's P, bf16
  float2 m[kTiles], l[kTiles];     // rows a and b of each row tile
#pragma unroll
  for (int r = 0; r < kTiles; ++r) {
    m[r] = make_float2(-INFINITY, -INFINITY);
    l[r] = make_float2(0.f, 0.f);
  }

  // One stream of key tiles over the block's items: step v issues S = Q K^T
  // of key tile v for the warpgroup's row tiles, then O += P V of key tile
  // v - 1, and computes tile v's softmax while the latter are in flight; at
  // an item's first step the P V products complete the previous item, whose
  // o and lse are stored. Every product is issued on every step (the last
  // step's scores read a stale stage and are not used): a product under a
  // condition makes ptxas serialise them all. The warpgroups issue
  // independently: taking turns, as K2 and K3 do, measured slower here.
  // thread 0 of each warpgroup issues its o stores; its slot is released
  // (pending) once they have read it
  const bool issuer = tid % 128 == 0;
  uint32_t pending = 0;
  for (int v = 0; v <= steps; ++v) {
    const int i = v / tiles, u = v - i * tiles;  // the scores' item, tile
    const int s = v % kRing, prev = (v + kRing - 1) % kRing;
    const uint32_t qs = slots + (i & 1) * kQSlot + kTiles * wg * kBox;
    float sacc[kTiles][32];
    if (pending != 0) {
      bulk_wait_read<0>();
      mbar_arrive(pending);
      pending = 0;
    }
    if (v < steps) {
      if (u == 0) mbar_wait(q_full + 8 * (i & 1), (i >> 1) & 1);
      mbar_wait(full + 8 * s, (v / kRing) & 1);
    }
    wgmma_fence();
    const uint64_t desc_k = wgmma_desc_sw128(ring + s * 2 * kBox);
    // 16 columns a step: 32 bytes into each swizzled row of Q and K
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
      const uint64_t desc_q = wgmma_desc_sw128(qs + r * kBox);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(sacc[r], desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    }
    wgmma_commit();
    // V read MN-major; the item's first key tile overwrites oacc
    const uint64_t desc_v = wgmma_desc_sw128(ring + prev * 2 * kBox + kBox);
#pragma unroll
    for (int r = 0; r < kTiles; ++r)
      out_product(oacc[r], pf[r], desc_v, u == (tiles > 1 ? 1 : 0));
    wgmma_commit();
    // item i's running maxima and sums start at its first key tile; item
    // i - 1's are kept for its finish
    float2 fin_m[kTiles], fin_l[kTiles];
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
      fin_m[r] = m[r];
      fin_l[r] = l[r];
      if (u == 0) {
        m[r] = make_float2(-INFINITY, -INFINITY);
        l[r] = make_float2(0.f, 0.f);
      }
    }
    wgmma_wait<1>();  // S is ready; P V may still run
    float2 alpha[kTiles];
#pragma unroll
    for (int r = 0; r < kTiles; ++r) {
      fence_operands(sacc[r]);
      alpha[r] = softmax_tile(sacc[r], n - u * 64, t, scale_log2, m[r], l[r]);
    }
    wgmma_wait<0>();  // P_{v-1} V_{v-1} is done: its stage is free
#pragma unroll
    for (int r = 0; r < kTiles; ++r) fence_operands(oacc[r]);
    if (v > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    if (u == 0 && v > 0) {
      // item i - 1 is complete: o = oacc / l rounded to bf16 into the
      // warpgroup's rows of its Q slot, which no product reads now, and
      // from there by TMA, one thread issuing; the slot is released once
      // the stores have read it (the issuing warp's arrival at the next
      // step)
      const int item = blockIdx.x + (i - 1) * gridDim.x;
      const int bh = item / walk.row_tiles;
      const int r0 = (item % walk.row_tiles) * kItemRows + wg * kTiles * 64;
      const uint32_t done =
          slots + ((i - 1) & 1) * kQSlot + kTiles * wg * kBox;
#pragma unroll
      for (int r = 0; r < kTiles; ++r) {
        const float la = quad_sum(fin_l[r].x), lb = quad_sum(fin_l[r].y);
        const float inv_a = 1.f / la, inv_b = 1.f / lb;
#pragma unroll
        for (int jj = 0; jj < 32; ++jj)
          oacc[r][jj] *= (jj % 4) < 2 ? inv_a : inv_b;
        stage_rows(smem + (done + r * kBox - s0), oacc[r], 1.f, warp, g, t);
        if (t == 0) {
          const int row_a = r0 + r * 64 + (warp % 4) * 16 + g;
          const int row_b = row_a + 8;
          if (row_a < n)
            lse[(size_t)bh * n + row_a] = (fin_m[r].x + log2f(la)) * kLn2;
          if (row_b < n)
            lse[(size_t)bh * n + row_b] = (fin_m[r].y + log2f(lb)) * kLn2;
        }
      }
      fence_proxy_async();  // the staged rows, before TMA reads them
      named_bar_sync(3 + wg, 128);
      if (issuer) {
#pragma unroll
        for (int r = 0; r < kTiles; ++r)
          tma_store_4d(&o_map, done + r * kBox, 0, bh % heads, r0 + r * 64,
                       bh / heads);
        bulk_commit();
        pending = q_empty + 8 * ((i - 1) & 1);
      } else if (lane == 0) {
        mbar_arrive(q_empty + 8 * ((i - 1) & 1));
      }
    } else if (u != 0) {
#pragma unroll
      for (int r = 0; r < kTiles; ++r) {
#pragma unroll
        for (int jj = 0; jj < 32; ++jj)
          oacc[r][jj] *= (jj % 4) < 2 ? alpha[r].x : alpha[r].y;
      }
    }
#pragma unroll
    for (int r = 0; r < kTiles; ++r) pack_steps(pf[r], sacc[r]);
  }
  if (issuer) bulk_wait<0>();  // the last stores are out
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

// The persistent kernel, for d <= 64 with 16-byte rows: q, k, v and o as
// 4-D tensor maps (d, head, token, batch), Q in boxes of 128 tokens (two an
// item), K, V and o of 64.
cudaError_t launch_tma(int batch, cudaStream_t st, View q, View k, View v,
                       View o, float* lse, int heads, int n, int d,
                       float scale) {
  CUtensorMap maps[4];
  const View* views[4] = {&q, &k, &v, &o};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = map_view(&maps[i], *views[i], batch, heads, n, d,
                                     i == 0 ? kRows : 64);
    if (err != cudaSuccess) return err;
  }
  int grid = 0;
  cudaError_t err = persistent_grid(
      (long long)batch * heads * ((n + kItemRows - 1) / kItemRows), &grid);
  if (err != cudaSuccess) return err;
  // the registers a thread starts with must let the producer's release
  // cover the consumers' growth, or their setmaxnreg would wait forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_tma);
  if (err != cudaSuccess) return err;
  if (kConsumers * (kConsumerRegs - attr.numRegs) >
      (kWsThreads - kConsumers) * (attr.numRegs - kProducerRegs))
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_fwd_tma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTmaSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_tma<<<grid, kWsThreads, kTmaSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, batch, heads, n,
      scale * kLog2e);
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
    if (d <= 64)
      return static_cast<int>(
          launch_tma(batch, st, qv, kv, vv, ov, ls, heads, n, d, scale));
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
