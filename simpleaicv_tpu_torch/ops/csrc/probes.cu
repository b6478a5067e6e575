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
// writes its column partials ([2, blocks_m, N] f32, reduced over its 128
// rows by warp shuffles and then over its 8 warps in a fixed order), and a
// second kernel sums the partials per column in a fixed order. The
// statistics are the same on every run; no atomics.
//
// P3: o = x * bf16(1.0001) over any number of bf16 elements, 16-byte
// vectors (8 values) in a grid-stride loop and a scalar tail. bf16(1.0001)
// is 1.0, so o is a copy of x, but every byte is read and written.
//
// Bounds (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): all three are bound by
// bytes. At ResNet-50's layer-1 shape (M 401,408, K 64, N 256) P1 must move
// 51.4 MB of x and write 205.5 MB of y, 76.7 us, against 13.3 us of
// operations; layer 2 (M 100,352, K 128, N 512) 38.4 us; P2 adds 2 N floats;
// P3 on [401408, 256] moves 411 MB, 122.7 us. P1's stream reads x once,
// issues its products from shared memory while the next tiles load, and
// stores y by TMA while it works on; P2 (mm_kernel<K, true>) still re-reads
// x once per 64-column block (the column blocks of a row tile run next to
// each other, so the re-reads hit L2) and reads x in 4-byte pieces.

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
// 32 columns x 32 row strides, then the 32 strides in order.
__global__ void __launch_bounds__(1024)
    col_reduce_kernel(const float* __restrict__ partial, float* s1, float* s2,
                      int nb, int N) {
  __shared__ float red[2][32][33];
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

// ------------------ P1, persistent TMA + wgmma stream ------------------

constexpr int kItemM = 64;            // rows of x an item
constexpr int kStreamWGs = 2;         // consumer warpgroups
constexpr int kStreamThreads = 128 * (kStreamWGs + 1);  // and the producer

constexpr int kMaxRing = 8;  // x tiles in flight, at most
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
// A ring shallower than this gives each consumer warpgroup less than two x
// tiles of its own: the two then share every item (see mm_stream).
constexpr int kShareRing = 4;

// Shared memory of mm_stream<K, NC> at N columns and a ring of R x tiles:
// 1024 bytes to align the swizzled tiles, w, the ring, two staging tiles of
// NC columns a consumer warpgroup, and the mbarriers (w's, at most 8, and
// the ring's).
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

// y = x @ w for K in {64, 128} and N a multiple of NC up to 512. A block an
// SM walks the 64-row items item = blockIdx.x + i * gridDim.x, each cut
// into N / NC chunks of NC columns, its units.
//   - The producer warpgroup's first thread loads w once (N / 64 atoms of K
//     rows x 64 columns, 128-byte swizzle), each chunk's columns on an
//     mbarrier of its own so that the first products wait for that chunk
//     alone, and the x tiles of the block's items through a ring of R
//     stages (TMA; rows past M read zero): the first chunk of w, the first R
//     tiles, then the rest of w.
//   - The two consumer warpgroups take the items in turn, all of an item's
//     units, where the ring holds kShareRing tiles or more (ResNet-50's
//     layer 1: 8). Where it holds fewer (layer 2, whose w fills 128 KB: 2)
//     and an item has two units or more, they share every item, consumer u
//     % 2 taking the block's unit u, so that the next item's tile loads
//     while both work on this one; taking turns, each would wait for its
//     next tile.
//   - For a unit, a consumer issues K / 16 products m64nNCk16 (A = the x
//     tile, K-major; B = the chunk of w read MN-major) and waits for them,
//     rounds the f32 accumulators to bf16 into one of its two swizzled
//     staging tiles and stores the tile by TMA (rows past M are not
//     written, evict-first in L2), one thread issuing, while it goes on to
//     its next unit. An x stage is released once the last of its item's
//     products have read it. Every product of a unit is issued
//     unconditionally.
//   - The launch allows programmatic stream serialization (launch_stream):
//     the blocks of a launch start on the SMs that the launch ahead of it
//     has left and wait (griddepcontrol.wait) before touching device
//     memory, so the last blocks of one persistent launch do not leave the
//     other SMs idle before the next starts.
template <int K, int NC>
__global__ void __launch_bounds__(kStreamThreads, 1)
    mm_stream(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap y_map, int M, int N,
              int R) {
  constexpr uint32_t kStage = (K / 64) * kBox;
  constexpr uint32_t kTile = (NC / 64) * kBox;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t wbase = (s0 + 1023) & ~1023u;
  const uint32_t ring = wbase + static_cast<uint32_t>(K) * N * 2;
  const uint32_t staging = ring + R * kStage;
  const uint32_t w_full = staging + kStreamWGs * 2 * kTile;  // 8 of them
  const uint32_t full = w_full + 8 * 8, empty = full + 8 * kMaxRing;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int items = (M + kItemM - 1) / kItemM;
  const int count = static_cast<int>(blockIdx.x) < items
                        ? (items - 1 - static_cast<int>(blockIdx.x)) /
                                  static_cast<int>(gridDim.x) + 1
                        : 0;
  const int chunks = N / NC;
  // whether the consumers share every item; its stage is then released by
  // both warpgroups' warps
  const bool split = chunks > 1 && R < kShareRing;
  // a launch that follows this one in the stream may set up its blocks as
  // this one's leave their SMs (its launch allows it; see launch_stream)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (warp == 4 * kStreamWGs && lane == 0) {
    // the tensor maps, fetched while the barriers are set up
    for (const CUtensorMap* map : {&x_map, &w_map, &y_map})
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
  }
  if (tid == 0) {
    for (int c = 0; c < chunks; ++c) mbar_init(w_full + 8 * c, 1);
    for (int s = 0; s < R; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, split ? 8 : 4);
    }
  }
  __syncthreads();
  // nothing in device memory is read or written before the work ahead of
  // this launch in the stream is complete and visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  if (warp >= 4 * kStreamWGs) {
    if (warp == 4 * kStreamWGs && lane == 0) {
      auto load_w = [&](int c) {
        mbar_arrive_expect_tx(w_full + 8 * c, K * NC * 2);
        for (int a = c * (NC / 64); a < (c + 1) * (NC / 64); ++a)
          tma_load_2d(wbase + a * K * 128, &w_map, a * 64, 0, w_full + 8 * c);
      };
      load_w(0);
      for (int i = 0; i < count; ++i) {
        if (i == R || (i == count - 1 && i < R))
          for (int c = 1; c < chunks; ++c) load_w(c);
        const int s = i % R;
        if (i >= R) mbar_wait(empty + 8 * s, (i / R - 1) & 1);
        mbar_arrive_expect_tx(full + 8 * s, kStage);
        const int row0 = (static_cast<int>(blockIdx.x) +
                          i * static_cast<int>(gridDim.x)) * kItemM;
#pragma unroll
        for (int kb = 0; kb < K / 64; ++kb)
          tma_load_2d(ring + s * kStage + kb * kBox, &x_map, kb * 64, row0,
                      full + 8 * s);
      }
      if (count == 0)
        for (int c = 1; c < chunks; ++c) load_w(c);
    }
    return;
  }

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const bool issuer = tid % 128 == 0;
  const int ra = (warp % 4) * 16 + g, rb = ra + 8;
  const uint64_t policy = evict_first();
  float acc[NC / 2];
  int filled = 0;  // staging tiles this warpgroup has filled
  const int units = count * chunks;
  for (int u = split ? wg : wg * chunks; u < units;) {
    const int i = u / chunks, c = u - i * chunks;
    const int s = i % R;
    mbar_wait(full + 8 * s, (i / R) & 1);
    mbar_wait(w_full + 8 * c, 0);
    const uint32_t xs = ring + s * kStage;
    const int row0 =
        (static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x)) *
        kItemM;
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
    // this warpgroup's next unit; the item's stage is released once the
    // warpgroup's last products of it have read it
    const int next = split ? u + kStreamWGs
                   : (c + 1 < chunks ? u + 1 : u + 1 + (kStreamWGs - 1) *
                                                           chunks);
    if (next / chunks != i && lane == 0) mbar_arrive(empty + 8 * s);
    // tile filled % 2 is free once the store issued from it two tiles ago
    // has read it
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
        tma_store_2d_hint(&y_map, buf + nb * kBox, c * NC + 64 * nb, row0,
                          policy);
      bulk_commit();
    }
    ++filled;
    u = next;
  }
  if (issuer) bulk_wait<0>();  // the last stores are out
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

template <int K, int NC>
int launch_stream(const void* x, const void* w, void* y, int M, int N,
                  cudaStream_t st) {
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
  err = cudaFuncSetAttribute(mm_stream<K, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  // programmatic stream serialization (mm_stream's notes)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kStreamThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mm_stream<K, NC>, maps[0], maps[1], maps[2],
                           M, N, ring);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  if (M < 1 || N < 64 || N > 512 || N % 64 || (K != 64 && K != 128) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 64)
    return N % 128 ? launch_stream<64, 64>(x, w, y, M, N, st)
                   : launch_stream<64, 128>(x, w, y, M, N, st);
  return N % 128 ? launch_stream<128, 64>(x, w, y, M, N, st)
                 : launch_stream<128, 128>(x, w, y, M, N, st);
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
