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
// y [M, N] bf16. A block of 8 warps takes 128 rows and 64 columns: it stages
// w's 64 columns (all K rows) in shared memory, each warp reads its 16 rows
// of x as mma.sync m16n8k16 A fragments straight from device memory and
// keeps 8 C tiles (16 x 64) in f32 registers; the bf16 tile is staged in
// shared memory and written in 16-byte vectors. K is 16 to 128 in steps of
// 16, N a multiple of 64; a ragged tail of M is masked (pallas_mm's grid of
// M // tile_m never writes a tail).
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
// P3 on [401408, 256] moves 411 MB, 122.7 us. This first design re-reads x
// once per 64-column block (N / 64 times; the column blocks of a row tile
// run next to each other, so the re-reads hit L2) and reads x in 4-byte
// pieces; a tile of all N columns, x staged by 16-byte or TMA loads and
// loads overlapped with the products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

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
