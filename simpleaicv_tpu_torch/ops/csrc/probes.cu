// Roofline probes of the ResNet-50 training step on Hopper (sm_90a), bf16:
// a 1x1 convolution written as a matrix product (P1), the same with
// BatchNorm's column statistics in its epilogue (P2), and an elementwise
// pass (P3).
//
// Replaces perf/pallas_matmul_probe.py::_mm_kernel (P1) and
// ::_mm_stats_kernel (P2), reached through pallas_mm, and
// perf/pallas_bw_probe.py::_scale_kernel (P3), reached through pallas_scale.
//
// P1: y = x @ w, x [M, K] and w [K, N] bf16 row-major, f32 accumulation,
// y [M, N] bf16. For K 64 or 128 and N a multiple of 64 up to 512, with x
// and w 16-byte aligned (ResNet-50's 1x1 expansions; perf/matmul_probe.py::
// _mm_variant), mm_stream: a persistent TMA + wgmma stream (its notes
// below), one block an SM keeping w in shared memory, x read once by TMA
// through a ring, y stored by TMA. Anything else takes P1's narrow variant,
// mm_kernel<K, false>: a block of 8 warps takes 128 rows and 64 columns: it
// stages w's 64 columns (all K rows) in shared memory, each warp reads its
// 16 rows of x as mma.sync m16n8k16 A fragments straight from device memory
// and keeps 8 C tiles (16 x 64) in f32 registers; the bf16 tile is staged in
// shared memory and written in 16-byte vectors. It takes K 16 to 128 in
// steps of 16, N a multiple of 64, x 4-byte aligned; a ragged tail of M is
// masked (pallas_mm's grid of M // tile_m never writes a tail), and it
// re-reads x once per 64-column block.
//
// P2: P1, plus sum(y) and sum(y^2) per column of the f32 product (before
// the bf16 rounding), [N] f32 each. The TPU carried the sums in scratch
// through its sequential grid; here blocks run in parallel, so each block
// writes one row of column partials ([2, blocks, N] f32) and a second
// kernel, col_reduce_kernel, sums the rows per column in a fixed order. The
// statistics are the same on every run; no atomics. P2 takes the same two
// kernels as P1 by the same rule:
//   - its stream, mm_stats_stream<K, NC, OWN>: P1's stream (the same
//     producer, products and stores) whose consumers also add their rows of
//     each unit's f32 accumulators into running column sums in registers
//     (rows past M are zeros from TMA and add 0), reduced once at the
//     block's end: over the 8 rows of a warp by shuffles, then over the
//     warps in a fixed order through shared memory (the ring and the
//     staging tiles, free once the last store has read them), into the
//     block's row of partials; one row a block (132), not one per 128 rows;
//   - its narrow variant, mm_kernel<K, true>: partials over each block's
//     128 rows, reduced by warp shuffles and then over its 8 warps.
// A consumer thread holds the sums of NC / 4 columns (its two of every 8)
// for each chunk it takes, NC / 2 registers a chunk. So P2's consumers take
// fixed chunks where an item has two or more (consumer c % 2 takes chunk
// c of every item, OWN = ceil(chunks / 2) of them), which bounds a thread's
// sums at 128 registers at every N up to 512, beside NC / 2 accumulators;
// setmaxnreg moves registers from the producer warpgroup (24 a thread) to
// the consumers (240), and the launch checks that the block starts at the
// 168 that this needs. Each chunk's sums have a slot fixed at compile time
// (an unrolled loop over the OWN chunks of an item): a slot picked at run
// time puts the sums in local memory (a stack frame in the -Xptxas -v log).
//
// P3: o = x * bf16(1.0001) over any number of bf16 elements, 16-byte
// vectors (8 values) in a grid-stride loop and a scalar tail. bf16(1.0001)
// is 1.0, so o is a copy of x, but every byte is read and written.
//
// Bounds (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): all three are bound by
// bytes. At ResNet-50's layer-1 shape (M 401,408, K 64, N 256) P1 must move
// 51.4 MB of x and write 205.5 MB of y, 76.7 us, against 13.3 us of
// operations; layer 2 (M 100,352, K 128, N 512) 38.4 us; P2 adds 2 N floats;
// P3 on [401408, 256] moves 411 MB, 122.7 us. The streams read x once,
// issue their products from shared memory while the next tiles load, and
// store y by TMA while they work on; P2's stream adds about 128 f32
// operations a unit to each consumer thread, a reduce at each block's end
// and the second launch. The narrow variants re-read x once per 64-column
// block (the column blocks of a row tile run next to each other, so the
// re-reads hit L2) and read x in 4-byte pieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_items.cuh"

namespace {

constexpr int kBM = 128;  // rows per block
constexpr int kBN = 64;   // columns per block
constexpr int kWarps = kBM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStr = kBN + 8;  // w tile row stride: 16-byte rows
constexpr unsigned kFull = 0xffffffffu;

template <int K, bool STATS>
__global__ void __launch_bounds__(kThreads)
    mm_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, __nv_bfloat16* y,
              float* partial, int M, int N) {
  __shared__ __align__(16) __nv_bfloat16 ws[K * kStr];
  // blockIdx.x walks the column blocks of one row tile, so x's rows are read
  // from device memory once and then from L2
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  for (int idx = threadIdx.x; idx < K * (kBN / 8); idx += kThreads) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    *reinterpret_cast<uint4*>(&ws[r * kStr + c]) =
        *reinterpret_cast<const uint4*>(&w[(long long)r * N + n0 + c]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = m0 + warp * 16 + g, row1 = row0 + 8;
  uint32_t a[K / 16][4];
  ld_a_global<K>(a, x, K, row0, M, K, t);
  float acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      uint32_t b0, b1;
      ld_b_cols(b0, b1, ws, kStr, kk * 16, j * 8, lane);
      mma_bf16(acc[j], a[kk], b0, b1);
    }
  }

  // the bf16 tile goes through shared memory, so that y is written in
  // 16-byte vectors, a row's 128 bytes by 8 neighbouring threads
  __shared__ __align__(16) __nv_bfloat16 ys[kBM * kStr];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(&ys[r0 * kStr + c]) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(&ys[(r0 + 8) * kStr + c]) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * (kBN / 8); idx += kThreads) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(&y[(long long)(m0 + r) * N + n0 + c]) =
          *reinterpret_cast<const uint4*>(&ys[r * kStr + c]);
  }

  if constexpr (STATS) {
    // column partials of the f32 product over this block's valid rows
    const bool ok0 = row0 < M, ok1 = row1 < M;
    __shared__ float red[2][kWarps][kBN];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float v0 = ok0 ? acc[j][0] : 0.f, v1 = ok0 ? acc[j][1] : 0.f;
      const float v2 = ok1 ? acc[j][2] : 0.f, v3 = ok1 ? acc[j][3] : 0.f;
      float s_a = v0 + v2, s_b = v1 + v3;
      float q_a = v0 * v0 + v2 * v2, q_b = v1 * v1 + v3 * v3;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over g: lane bits 2..4
        s_a += __shfl_xor_sync(kFull, s_a, off);
        s_b += __shfl_xor_sync(kFull, s_b, off);
        q_a += __shfl_xor_sync(kFull, q_a, off);
        q_b += __shfl_xor_sync(kFull, q_b, off);
      }
      if (g == 0) {
        red[0][warp][j * 8 + 2 * t] = s_a;
        red[0][warp][j * 8 + 2 * t + 1] = s_b;
        red[1][warp][j * 8 + 2 * t] = q_a;
        red[1][warp][j * 8 + 2 * t + 1] = q_b;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kBN) {
      const int which = threadIdx.x / kBN, c = threadIdx.x % kBN;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[which][wi][c];
      partial[((long long)which * gridDim.y + blockIdx.y) * N + n0 + c] = s;
    }
  }
}

// s1[c] = sum_i partial[0][i][c], s2[c] = sum_i partial[1][i][c]: a block of
// 32 columns x 32 row strides, then the 32 strides in order. After P2's
// stream it is launched with programmatic stream serialization, so that its
// blocks start as the stream's leave their SMs; it reads nothing before the
// stream is complete (griddepcontrol.wait, which returns at once where the
// launch is an ordinary one, after the narrow variant).
__global__ void __launch_bounds__(1024)
    col_reduce_kernel(const float* __restrict__ partial, float* s1, float* s2,
                      int nb, int N) {
  __shared__ float red[2][32][33];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int c = blockIdx.x * 32 + threadIdx.x, r = threadIdx.y;
  float a = 0.f, b = 0.f;
  if (c < N) {
    for (int i = r; i < nb; i += 32) {
      a += partial[(long long)i * N + c];
      b += partial[((long long)nb + i) * N + c];
    }
  }
  red[0][r][threadIdx.x] = a;
  red[1][r][threadIdx.x] = b;
  __syncthreads();
  if (r == 0 && c < N) {
    float sa = 0.f, sb = 0.f;
    for (int i = 0; i < 32; ++i) {
      sa += red[0][i][threadIdx.x];
      sb += red[1][i][threadIdx.x];
    }
    s1[c] = sa;
    s2[c] = sb;
  }
}

template <int K>
int launch_mm(const __nv_bfloat16* x, const __nv_bfloat16* w,
              __nv_bfloat16* y, float* partial, int M, int N, bool stats,
              cudaStream_t st) {
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  if (stats)
    mm_kernel<K, true><<<grid, kThreads, 0, st>>>(x, w, y, partial, M, N);
  else
    mm_kernel<K, false><<<grid, kThreads, 0, st>>>(x, w, y, partial, M, N);
  return cudaGetLastError();
}

// ---------------- P1 and P2, persistent TMA + wgmma stream ----------------

constexpr int kItemM = 64;            // rows of x an item
constexpr int kStreamWGs = 2;         // consumer warpgroups
constexpr int kStreamThreads = 128 * (kStreamWGs + 1);  // and the producer

constexpr int kMaxRing = 8;  // x tiles in flight, at most
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
// A ring shallower than this gives each consumer warpgroup less than two x
// tiles of its own: P1's two then share every item (see mm_stream).
constexpr int kShareRing = 4;
// P2's registers a thread after setmaxnreg (see the file's notes)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Shared memory of a stream (Stream<K, NC>) at N columns and a ring of R x
// tiles: 1024 bytes to align the swizzled tiles, w, the ring, two staging
// tiles of NC columns a consumer warpgroup, and the mbarriers (w's, at most
// 8, and the ring's).
template <int K, int NC>
constexpr int stream_smem(int N, int R) {
  return 1024 + K * N * 2 + R * (K / 64) * kBox +
         kStreamWGs * 2 * (NC / 64) * kBox + (8 + 2 * kMaxRing) * 8;
}

// An L2 policy that evicts first what it is attached to: y is written once
// and read by no later part of the kernel, so it should not push x or w out
// of L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void tma_store_2d_hint(const void* map,
                                                  uint32_t src, int c0,
                                                  int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "l"(policy)
      : "memory");
}

// P2's sums of a unit: the thread's rows ra and rb of each of its NC / 4
// columns (accumulators as wgmma lays them out, sm90_tiles.cuh) added into
// its running column sums and sums of squares.
template <int NC>
__device__ __forceinline__ void add_col_sums(float (&s1)[NC / 4],
                                             float (&s2)[NC / 4],
                                             const float (&acc)[NC / 2]) {
#pragma unroll
  for (int jj = 0; jj < NC / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = acc[4 * jj + e], b = acc[4 * jj + 2 + e];
      s1[2 * jj + e] += a + b;
      s2[2 * jj + e] = fmaf(a, a, fmaf(b, b, s2[2 * jj + e]));
    }
  }
}

// What the streams (P1's mm_stream, P2's mm_stats_stream) share: where a
// block keeps w, the ring of x tiles, the staging tiles and the mbarriers in
// shared memory, and its walk of the 64-row items item = blockIdx.x + i *
// gridDim.x (i < count), each cut into `chunks` chunks of NC columns, its
// units.
//   - The producer warpgroup's first thread loads w once (N / 64 atoms of K
//     rows x 64 columns, 128-byte swizzle), each chunk's columns on an
//     mbarrier of its own so that the first products wait for that chunk
//     alone, and the x tiles of the block's items through a ring of R
//     stages (TMA; rows past M read zero): the first chunk of w, the first R
//     tiles, then the rest of w.
//   - For a unit, a consumer warpgroup issues K / 16 products m64nNCk16 (A =
//     the x tile, K-major; B = the chunk of w read MN-major) and waits for
//     them, rounds the f32 accumulators to bf16 into one of its two swizzled
//     staging tiles and stores the tile by TMA (rows past M are not
//     written, evict-first in L2), one thread issuing, while it goes on to
//     its next unit. An x stage is released once the last of its item's
//     products have read it. Every product of a unit is issued
//     unconditionally.
//   - The launch allows programmatic stream serialization (launch_pss): the
//     blocks of a launch start on the SMs that the launch ahead of it has
//     left and wait (griddepcontrol.wait) before touching device memory, so
//     the last blocks of one persistent launch do not leave the other SMs
//     idle before the next starts.
template <int K, int NC>
struct Stream {
  static constexpr uint32_t kStage = (K / 64) * kBox;  // an x tile
  static constexpr uint32_t kTile = (NC / 64) * kBox;  // a staging tile
  unsigned char* smem;
  uint32_t s0, wbase, ring, staging, w_full, full, empty;
  int count, chunks, R;

  __device__ __forceinline__ Stream(unsigned char* p, int M, int N, int r)
      : smem(p), R(r) {
    s0 = smem_u32(p);
    wbase = (s0 + 1023) & ~1023u;
    ring = wbase + static_cast<uint32_t>(K) * N * 2;
    staging = ring + R * kStage;
    w_full = staging + kStreamWGs * 2 * kTile;  // 8 of them
    full = w_full + 8 * 8;
    empty = full + 8 * kMaxRing;
    const int items = (M + kItemM - 1) / kItemM;
    const int b = static_cast<int>(blockIdx.x);
    count = b < items ? (items - 1 - b) / static_cast<int>(gridDim.x) + 1 : 0;
    chunks = N / NC;
  }

  __device__ __forceinline__ int row0(int i) const {
    return (static_cast<int>(blockIdx.x) +
            i * static_cast<int>(gridDim.x)) * kItemM;
  }

  // Sets up the mbarriers (an x stage released by `releases` consumer
  // warps) and waits until the work ahead of this launch in the stream is
  // complete and visible; a launch that follows this one may set up its
  // blocks as this one's leave their SMs.
  __device__ __forceinline__ void begin(const CUtensorMap* x_map,
                                        const CUtensorMap* w_map,
                                        const CUtensorMap* y_map,
                                        int releases) const {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    if (threadIdx.x == 128 * kStreamWGs) {
      // the tensor maps, fetched while the barriers are set up
      for (const CUtensorMap* map : {x_map, w_map, y_map})
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
    }
    if (threadIdx.x == 0) {
      for (int c = 0; c < chunks; ++c) mbar_init(w_full + 8 * c, 1);
      for (int s = 0; s < R; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, releases);
      }
    }
    __syncthreads();
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }

  // The producer's thread: w and the x tiles (the notes above).
  __device__ __forceinline__ void produce(const CUtensorMap* x_map,
                                          const CUtensorMap* w_map) const {
    auto load_w = [&](int c) {
      mbar_arrive_expect_tx(w_full + 8 * c, K * NC * 2);
      for (int a = c * (NC / 64); a < (c + 1) * (NC / 64); ++a)
        tma_load_2d(wbase + a * K * 128, w_map, a * 64, 0, w_full + 8 * c);
    };
    load_w(0);
    for (int i = 0; i < count; ++i) {
      if (i == R || (i == count - 1 && i < R))
        for (int c = 1; c < chunks; ++c) load_w(c);
      const int s = i % R;
      if (i >= R) mbar_wait(empty + 8 * s, (i / R - 1) & 1);
      mbar_arrive_expect_tx(full + 8 * s, kStage);
#pragma unroll
      for (int kb = 0; kb < K / 64; ++kb)
        tma_load_2d(ring + s * kStage + kb * kBox, x_map, kb * 64, row0(i),
                    full + 8 * s);
    }
    if (count == 0)
      for (int c = 1; c < chunks; ++c) load_w(c);
  }

  // A unit's products: item i's x tile times chunk c of w into acc.
  __device__ __forceinline__ void products(float (&acc)[NC / 2], int i,
                                           int c) const {
    const int s = i % R;
    mbar_wait(full + 8 * s, (i / R) & 1);
    mbar_wait(w_full + 8 * c, 0);
    const uint32_t xs = ring + s * kStage;
    wgmma_fence();
    const uint64_t db = wgmma_desc_sw128_mn(wbase + c * NC * K * 2, K * 128);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_ss_tb<NC>(acc,
                      wgmma_desc_sw128(xs + (kk / 4) * kBox) + 2 * (kk % 4),
                      db + 128 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
  }

  // Rounds a unit's accumulators to bf16 into warpgroup wg's staging tile
  // filled % 2, free once the store issued from it two tiles ago has read
  // it, and stores the tile by TMA at column c * NC, row row0.
  __device__ __forceinline__ void store(const float (&acc)[NC / 2],
                                        const CUtensorMap* y_map, int c,
                                        int row0, int wg, int filled,
                                        uint64_t policy) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int ra = (warp % 4) * 16 + g, rb = ra + 8;
    const bool issuer = threadIdx.x % 128 == 0;
    const uint32_t buf = staging + (wg * 2 + (filled & 1)) * kTile;
    if (issuer) bulk_wait_read<1>();
    named_bar_sync(1 + wg, 128);
    unsigned char* tile = smem + (buf - s0);
#pragma unroll
    for (int jj = 0; jj < NC / 8; ++jj) {
      const int col = 8 * (jj % 8) + 2 * t;
      unsigned char* box = tile + (jj / 8) * kBox;
      *reinterpret_cast<__nv_bfloat162*>(box + sw128(ra, col)) =
          __floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]);
      *reinterpret_cast<__nv_bfloat162*>(box + sw128(rb, col)) =
          __floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
    fence_proxy_async();  // the staged rows, before TMA reads them
    named_bar_sync(1 + wg, 128);
    if (issuer) {
#pragma unroll
      for (int nb = 0; nb < NC / 64; ++nb)
        tma_store_2d_hint(y_map, buf + nb * kBox, c * NC + 64 * nb, row0,
                          policy);
      bulk_commit();
    }
  }
};

// P1: y = x @ w for K in {64, 128} and N a multiple of NC up to 512. The two
// consumer warpgroups take the items in turn, all of an item's units, where
// the ring holds kShareRing tiles or more (ResNet-50's layer 1: 8). Where it
// holds fewer (layer 2, whose w fills 128 KB: 2) and an item has two units
// or more, they share every item, consumer u % 2 taking the block's unit u,
// so that the next item's tile loads while both work on this one; taking
// turns, each would wait for its next tile.
template <int K, int NC>
__global__ void __launch_bounds__(kStreamThreads, 1)
    mm_stream(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap y_map, int M, int N,
              int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Stream<K, NC> b(smem, M, N, R);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = b.chunks;
  // whether the consumers share every item; its stage is then released by
  // both warpgroups' warps
  const bool split = chunks > 1 && R < kShareRing;
  b.begin(&x_map, &w_map, &y_map, split ? 8 : 4);
  if (warp >= 4 * kStreamWGs) {
    if (warp == 4 * kStreamWGs && lane == 0) b.produce(&x_map, &w_map);
    return;
  }

  const int wg = warp / 4;
  const uint64_t policy = evict_first();
  float acc[NC / 2];
  int filled = 0;  // staging tiles this warpgroup has filled
  const int units = b.count * chunks;
  for (int u = split ? wg : wg * chunks; u < units;) {
    const int i = u / chunks, c = u - i * chunks;
    b.products(acc, i, c);
    // this warpgroup's next unit; the item's stage is released once the
    // warpgroup's last products of it have read it
    const int next = split ? u + kStreamWGs
                   : (c + 1 < chunks ? u + 1 : u + 1 + (kStreamWGs - 1) *
                                                           chunks);
    if (next / chunks != i && lane == 0) mbar_arrive(b.empty + 8 * (i % R));
    b.store(acc, &y_map, c, b.row0(i), wg, filled, policy);
    ++filled;
    u = next;
  }
  if (threadIdx.x % 128 == 0) bulk_wait<0>();  // the last stores are out
}

// P2: P1 and the column sums of the f32 product into partial's row
// blockIdx.x ([2][gridDim.x][N]). Where an item has two chunks or more,
// consumer wg takes chunks wg, wg + 2, ... of every item, OWN of them
// (ceil(chunks / 2)), each summed into slot o of its registers, a slot
// fixed at compile time; where the chunks are odd, consumer 1's last is a
// stand-in whose products (of its previous chunk) are neither stored nor
// summed, so that no product is issued under a condition. Where an item has
// one chunk (OWN 1), the consumers take the items in turn. At the block's
// end the sums are reduced in a fixed order (the file's notes).
template <int K, int NC, int OWN>
__global__ void __launch_bounds__(kStreamThreads, 1)
    mm_stats_stream(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap y_map,
                    float* partial, int M, int N, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Stream<K, NC> b(smem, M, N, R);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = b.chunks;
  const bool split = chunks > 1;
  b.begin(&x_map, &w_map, &y_map, split ? 8 : 4);
  if (warp >= 4 * kStreamWGs) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kStreamWGs && lane == 0) b.produce(&x_map, &w_map);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const uint64_t policy = evict_first();
  float acc[NC / 2];
  // the running sums of this thread's columns of each chunk it takes
  float s1[OWN][NC / 4], s2[OWN][NC / 4];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
#pragma unroll
    for (int j = 0; j < NC / 4; ++j) s1[o][j] = s2[o][j] = 0.f;
  }
  int filled = 0;  // staging tiles this warpgroup has filled
  for (int i = split ? 0 : wg; i < b.count; i += split ? 1 : kStreamWGs) {
#pragma unroll
    for (int o = 0; o < OWN; ++o) {
      const int own = split ? wg + kStreamWGs * o : 0;
      const bool real = own < chunks;
      const int c = real ? own : own - kStreamWGs;
      b.products(acc, i, c);
      if (o == OWN - 1 && lane == 0) mbar_arrive(b.empty + 8 * (i % R));
      if (real) {
        add_col_sums<NC>(s1[o], s2[o], acc);
        b.store(acc, &y_map, c, b.row0(i), wg, filled, policy);
        ++filled;
      }
    }
  }
  if (tid % 128 == 0) bulk_wait<0>();  // the last stores are out

  // Every product has read its x tile and every store its staging tile, so
  // the ring and the staging tiles hold red[2][8 warps][N] f32: each warp's
  // sums of the columns it took, over its 16 rows of every unit.
  named_bar_sync(3, 128 * kStreamWGs);
  float* red = reinterpret_cast<float*>(smem + (b.ring - b.s0));
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    const int c = split ? wg + kStreamWGs * o : 0;
    if (c >= chunks) continue;
#pragma unroll
    for (int j = 0; j < NC / 4; ++j) {
      float sa = s1[o][j], sb = s2[o][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over g: lane bits 2..4
        sa += __shfl_xor_sync(kFull, sa, off);
        sb += __shfl_xor_sync(kFull, sb, off);
      }
      if (g == 0) {
        const int col = c * NC + 8 * (j / 2) + 2 * t + j % 2;
        red[warp * N + col] = sa;
        red[(4 * kStreamWGs + warp) * N + col] = sb;
      }
    }
  }
  named_bar_sync(3, 128 * kStreamWGs);
  // the block's row: each column over the warps that took it, in order
  for (int idx = tid; idx < 2 * N; idx += 128 * kStreamWGs) {
    const int which = idx / N, col = idx - which * N;
    const int w0 = split ? (col / NC) % kStreamWGs * 4 : 0;
    const int w1 = split ? w0 + 4 : 4 * kStreamWGs;
    float sum = 0.f;
    for (int wi = w0; wi < w1; ++wi)
      sum += red[(which * 4 * kStreamWGs + wi) * N + col];
    partial[((long long)which * gridDim.x + blockIdx.x) * N + col] = sum;
  }
}

// The tensor map of a row-major [rows, cols] bf16 matrix read or written in
// boxes of box_rows x 64 columns.
cudaError_t map_rows(CUtensorMap* map, const void* p, int rows, int cols,
                     int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return tensor_map_bf16(map, p, 2, dims, strides, box);
}

// Launches kernel with programmatic stream serialization (the streams'
// notes), after raising its dynamic shared memory to `smem` bytes.
template <typename... Params, typename... Args>
cudaError_t launch_pss(void (*kernel)(Params...), dim3 grid, dim3 block,
                       int smem, cudaStream_t st, Args... args) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// P2's scratch: partial holds partial_rows rows of N floats for each sum.
struct ColSums {
  float* partial;
  float* s1;
  float* s2;
  int partial_rows;
};

// Launches P1's stream (OWN 0, sums null) or P2's (mm_stats_stream with
// OWN chunks a consumer, then col_reduce over its blocks' rows).
template <int K, int NC, int OWN>
int launch_stream(const void* x, const void* w, void* y, const ColSums* sums,
                  int M, int N, cudaStream_t st) {
  CUtensorMap maps[3];
  cudaError_t err = map_rows(&maps[0], x, M, K, kItemM);
  if (err == cudaSuccess) err = map_rows(&maps[1], w, K, N, K);
  if (err == cudaSuccess) err = map_rows(&maps[2], y, M, N, kItemM);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid((M + kItemM - 1) / kItemM, &grid);
  if (err != cudaSuccess) return err;
  int ring = kMaxRing;
  while (ring > 2 && stream_smem<K, NC>(N, ring) > kMaxSmem) --ring;
  const int smem = stream_smem<K, NC>(N, ring);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if constexpr (OWN == 0) {
    err = launch_pss(mm_stream<K, NC>, dim3(grid), dim3(kStreamThreads), smem,
                     st, maps[0], maps[1], maps[2], M, N, ring);
  } else {
    // a row of partials a block; the block's reduce in the ring and the
    // staging tiles; and the registers a thread starts with must let the
    // producer's release cover the consumers' growth, or their setmaxnreg
    // would wait forever
    if (grid > sums->partial_rows ||
        2 * 4 * kStreamWGs * N * 4 >
            ring * static_cast<int>(Stream<K, NC>::kStage) +
                kStreamWGs * 2 * static_cast<int>(Stream<K, NC>::kTile))
      return cudaErrorInvalidValue;
    static const cudaError_t regs = [] {
      cudaFuncAttributes fa;
      const cudaError_t e = cudaFuncGetAttributes(&fa,
                                                  mm_stats_stream<K, NC, OWN>);
      if (e != cudaSuccess) return e;
      return 128 * kStreamWGs * (kConsumerRegs - fa.numRegs) >
                     128 * (fa.numRegs - kProducerRegs)
                 ? cudaErrorInvalidConfiguration
                 : cudaSuccess;
    }();
    if (regs != cudaSuccess) return regs;
    err = launch_pss(mm_stats_stream<K, NC, OWN>, dim3(grid),
                     dim3(kStreamThreads), smem, st, maps[0], maps[1],
                     maps[2], sums->partial, M, N, ring);
    if (err == cudaSuccess)
      err = launch_pss(col_reduce_kernel, dim3((N + 31) / 32), dim3(32, 32),
                       0, st, static_cast<const float*>(sums->partial),
                       sums->s1, sums->s2, grid, N);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// P2's stream at the chunks a consumer takes: ceil(chunks / 2), or 1 where
// an item has one chunk (mm_stats_stream).
template <int K, int NC>
int launch_stats_stream(const void* x, const void* w, void* y,
                        const ColSums* sums, int M, int N, cudaStream_t st) {
  const int chunks = N / NC, own = chunks == 1 ? 1 : (chunks + 1) / 2;
  if (own == 1) return launch_stream<K, NC, 1>(x, w, y, sums, M, N, st);
  if (own == 2) return launch_stream<K, NC, 2>(x, w, y, sums, M, N, st);
  if constexpr (NC == 64) {  // N 320 and 448: 5 and 7 chunks
    if (own == 3) return launch_stream<K, NC, 3>(x, w, y, sums, M, N, st);
    if (own == 4) return launch_stream<K, NC, 4>(x, w, y, sums, M, N, st);
  }
  return cudaErrorInvalidValue;
}

// What the streams take: K 64 or 128, N a multiple of 64 up to 512, 1 <= M
// < 2^31, pointers 16-byte aligned.
bool stream_takes(const void* x, const void* w, const void* y, int M, int K,
                  int N) {
  return M >= 1 && N >= 64 && N <= 512 && N % 64 == 0 &&
         (K == 64 || K == 128) && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

// P1's (sums null) or P2's stream, with chunks of 128 columns where N allows
// it, else of 64.
int launch_stream_for(const void* x, const void* w, void* y,
                      const ColSums* sums, int M, int K, int N,
                      cudaStream_t st) {
  if (sums == nullptr) {
    if (K == 64)
      return N % 128 ? launch_stream<64, 64, 0>(x, w, y, sums, M, N, st)
                     : launch_stream<64, 128, 0>(x, w, y, sums, M, N, st);
    return N % 128 ? launch_stream<128, 64, 0>(x, w, y, sums, M, N, st)
                   : launch_stream<128, 128, 0>(x, w, y, sums, M, N, st);
  }
  if (K == 64)
    return N % 128 ? launch_stats_stream<64, 64>(x, w, y, sums, M, N, st)
                   : launch_stats_stream<64, 128>(x, w, y, sums, M, N, st);
  return N % 128 ? launch_stats_stream<128, 64>(x, w, y, sums, M, N, st)
                 : launch_stats_stream<128, 128>(x, w, y, sums, M, N, st);
}

__global__ void scale_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ o, long long n) {
  const __nv_bfloat162 s2 = __bfloat162bfloat162(__float2bfloat16(1.0001f));
  const long long n_vec = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < n_vec; i += stride) {
    uint4 v = reinterpret_cast<const uint4*>(x)[i];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __hmul2(h[k], s2);
    reinterpret_cast<uint4*>(o)[i] = v;
  }
  for (long long i = n_vec * 8 + first; i < n; i += stride)
    o[i] = __hmul(x[i], s2.x);
}

}  // namespace

extern "C" {

// P1 (stats == 0) or P2 (stats != 0). 1 <= M <= 65535 * 128, K in
// {16, 32, ..., 128}, N a positive multiple of 64, pointers 16-byte
// aligned. P2 takes partial [2, ceil(M / 128), N] f32 scratch and writes
// s1 and s2 [N]. Returns 0 or the CUDA error of a launch.
int probe_mm(const void* x, const void* w, void* y, float* partial, float* s1,
             float* s2, int M, int K, int N, int stats, void* stream) {
  if (M < 1 || (M + kBM - 1) / kBM > 65535 || N < kBN || N % kBN || K < 16 ||
      K > 128 || K % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  int err = cudaErrorInvalidValue;
  switch (K / 16) {
    case 1: err = launch_mm<16>(xb, wb, yb, partial, M, N, stats, st); break;
    case 2: err = launch_mm<32>(xb, wb, yb, partial, M, N, stats, st); break;
    case 3: err = launch_mm<48>(xb, wb, yb, partial, M, N, stats, st); break;
    case 4: err = launch_mm<64>(xb, wb, yb, partial, M, N, stats, st); break;
    case 5: err = launch_mm<80>(xb, wb, yb, partial, M, N, stats, st); break;
    case 6: err = launch_mm<96>(xb, wb, yb, partial, M, N, stats, st); break;
    case 7: err = launch_mm<112>(xb, wb, yb, partial, M, N, stats, st); break;
    case 8: err = launch_mm<128>(xb, wb, yb, partial, M, N, stats, st); break;
  }
  if (err != cudaSuccess || !stats) return err;
  const int nb = (M + kBM - 1) / kBM;
  col_reduce_kernel<<<(N + 31) / 32, dim3(32, 32), 0, st>>>(partial, s1, s2,
                                                            nb, N);
  return cudaGetLastError();
}

// P1's stream: K 64 or 128, N a multiple of 64 up to 512, 1 <= M < 2^31,
// pointers 16-byte aligned; cudaErrorInvalidValue for anything else (P1's
// narrow variant, probe_mm, takes it).
int probe_mm_stream(const void* x, const void* w, void* y, int M, int K,
                    int N, void* stream) {
  if (!stream_takes(x, w, y, M, K, N)) return cudaErrorInvalidValue;
  return launch_stream_for(x, w, y, nullptr, M, K, N,
                           static_cast<cudaStream_t>(stream));
}

// P2's stream: what P1's stream takes; partial [2, partial_rows, N] f32
// scratch with partial_rows at least the persistent grid (ceil(M / 64) or
// the SMs, whichever is fewer); writes s1 and s2 [N].
// cudaErrorInvalidValue for anything else (P2's narrow variant, probe_mm
// with stats, takes it).
int probe_mm_stats_stream(const void* x, const void* w, void* y,
                          float* partial, float* s1, float* s2,
                          int partial_rows, int M, int K, int N,
                          void* stream) {
  if (!stream_takes(x, w, y, M, K, N) || partial == nullptr ||
      s1 == nullptr || s2 == nullptr)
    return cudaErrorInvalidValue;
  const ColSums sums = {partial, s1, s2, partial_rows};
  return launch_stream_for(x, w, y, &sums, M, K, N,
                           static_cast<cudaStream_t>(stream));
}

// P3 over n bf16 values; pointers 16-byte aligned.
int probe_scale(const void* x, void* o, long long n, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long n_vec = n / 8;
  long long blocks = (n_vec + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  scale_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(o),
      n);
  return cudaGetLastError();
}

}  // extern "C"
