// Device helpers of the Hopper (sm_90a) kernels (flash_fwd.cu, flash_bwd.cu,
// flash_relpos_fwd.cu, flash_relpos_bwd.cu): 16- and 4-byte cp.async copies
// into shared-memory tiles, mbarriers, TMA loads and stores and their tensor
// maps, ldmatrix.x4,
// base-2 exponentials, and wgmma with its shared-memory descriptors, fences
// and waits.
//
// Two layouts of a [ROWS][COLS] bf16 tile in shared memory:
//   Padded<STR>: row-major with a row stride of STR elements (COLS + 8), so
//     that the eight row addresses of an ldmatrix fall in eight different
//     16-byte bank groups;
//   Core<COLS>: wgmma's layout without swizzle: 8x8 core matrices of 128
//     contiguous bytes (row r%8 at 16 bytes * (r%8)), the core matrices of
//     one 8-row group side by side along the columns (128 bytes apart), the
//     8-row groups COLS * 16 bytes apart.
// Copies map eight consecutive threads onto eight consecutive rows of one
// 16-byte column, which writes either layout without bank conflicts and
// reads whole 32-byte sectors from device memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst, or 16 zero bytes when !fill (src is not
// read then, but must be a valid address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(fill ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// orders this thread's shared-memory writes (cp.async included) before
// later reads by the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------ mbarriers ---------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// One arrival on bar once all of this thread's earlier cp.async copies have
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits until the phase of bar with this parity has completed (the k-th
// completion, counting from 0, has parity k & 1). A wait that outlasts
// 2^32 clock cycles (two to three seconds) traps, so that a broken
// pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 32)) {
      __trap();
    }
  }
}

// One arrival on bar that also expects `bytes` more of asynchronous copies
// (TMA) before the phase can complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// TMA: the box of a 2-D tensor map at (column c0, row c1) into shared dst,
// counted in on bar's transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// TMA store: the box of a 4-D tensor map at (c0, c1, c2, c3) from shared
// src (elements outside the tensor are not written), in the thread's bulk
// group; bulk_commit closes the group, bulk_wait_read<N> waits until at most
// N of the thread's groups still read shared memory, bulk_wait<N> until at
// most N are still writing.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// Host: the tensor map of a tensor of `rank` dimensions (dims from the
// innermost, which is contiguous; byte strides of the others, multiples of
// 16) read in boxes of `box` elements whose first dimension spans 128 bytes
// (128-byte swizzle); elements outside the tensor read zero.
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so nothing links against libcuda.
inline cudaError_t tensor_map_sw128(CUtensorMap* map,
                                    CUtensorMapDataType type,
                                    const void* base, int rank,
                                    const cuuint64_t* dims,
                                    const cuuint64_t* strides,
                                    const cuuint32_t* box) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: boxes of 64 elements across
inline cudaError_t tensor_map_bf16(CUtensorMap* map, const void* base,
                                   int rank, const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box) {
  return tensor_map_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank,
                          dims, strides, box);
}

// f32: boxes of 32 elements across. In shared memory element (r, c) of a
// box lands at r * 128 + (((c / 4) ^ (r % 8)) * 16) + (c % 4) * 4 bytes
// from the box's 1024-byte aligned start.
inline cudaError_t tensor_map_f32(CUtensorMap* map, const void* base,
                                  int rank, const cuuint64_t* dims,
                                  const cuuint64_t* strides,
                                  const cuuint32_t* box) {
  return tensor_map_sw128(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank,
                          dims, strides, box);
}

// Moves registers between warpgroups: a producer gives up what it does not
// need, the consumers take it (every warp of a warpgroup executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `threads` threads:
// sync waits for them all, arrive counts this thread and goes on.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int STR>
struct Padded {
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    return static_cast<uint32_t>((r * STR + c) * 2);
  }
};

template <int COLS>
struct Core {
  static constexpr uint32_t kGroupBytes = COLS * 16;  // one 8-row group
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    return static_cast<uint32_t>((r >> 3) * kGroupBytes + (c >> 3) * 128 +
                                 (r & 7) * 16 + (c & 7) * 2);
  }
};

// Issues the copies of rows [0, ROWS) x columns [0, COLS) of a bf16 tile
// whose row r starts at src + r * row_stride into the shared tile at dst
// (Layout), zero-filling rows >= rows and columns >= cols. VEC copies 16
// bytes a thread (src and row_stride 16-byte aligned, cols a multiple of
// 8); else 4 bytes (4-byte aligned, cols even). Does not commit.
template <int ROWS, int COLS, bool VEC, class Layout, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int cols, int tid) {
  if constexpr (VEC) {
    constexpr int CH = COLS / 8;
    static_assert(ROWS % 8 == 0 && COLS % 8 == 0, "8x8 chunks");
#pragma unroll 4
    for (int i = tid; i < ROWS * CH; i += THREADS) {
      const int r = (i & 7) + ((i / (8 * CH)) << 3);
      const int c = ((i >> 3) % CH) * 8;
      const bool ok = r < rows && c < cols;
      cp_async_16(dst + Layout::offset(r, c),
                  ok ? src + r * row_stride + c : src, ok);
    }
  } else {
    constexpr int PR = COLS / 2;
#pragma unroll 4
    for (int i = tid; i < ROWS * PR; i += THREADS) {
      const int r = i / PR, c = (i % PR) * 2;
      const bool ok = r < rows && c < cols;
      cp_async_4(dst + Layout::offset(r, c),
                 ok ? src + r * row_stride + c : src, ok);
    }
  }
}

// One thread's share of the 16-byte copies of a [ROWS][COLS] bf16 tile into
// Layout, as load_tile<..., true, ...> makes them, with the rows, columns
// and shared-memory offsets worked out once for every tile of a walk.
template <int ROWS, int COLS, class Layout, int THREADS>
struct TileCopy16 {
  static constexpr int kChunks = ROWS * COLS / 8;
  static constexpr int kPer = (kChunks + THREADS - 1) / THREADS;
  int r[kPer], c[kPer];  // r = ROWS: no chunk for this thread
  uint32_t soff[kPer];

  __device__ __forceinline__ explicit TileCopy16(int tid) {
    constexpr int CH = COLS / 8;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * THREADS;
      r[j] = i < kChunks ? (i & 7) + ((i / (8 * CH)) << 3) : ROWS;
      c[j] = ((i >> 3) % CH) * 8;
      soff[j] = Layout::offset(r[j] < ROWS ? r[j] : 0, c[j]);
    }
  }

  // row r of the source at src + r * stride; zero-fills rows >= rows and
  // columns >= cols; does not commit
  __device__ __forceinline__ void issue(uint32_t dst,
                                        const __nv_bfloat16* src,
                                        long long stride, int rows,
                                        int cols) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (kChunks % THREADS != 0 && r[j] >= ROWS) continue;
      const bool ok = r[j] < rows && c[j] < cols;
      cp_async_16(dst + soff[j], ok ? src + r[j] * stride + c[j] : src, ok);
    }
  }
};

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and lane (g = lane/4, t = lane%4) receives row g, columns 2t and 2t+1 of
// each (with .trans: rows 2t and 2t+1 of column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x on the special-function unit (ex2.approx; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------- wgmma ----------------------------------

// Shared-memory matrix descriptor without swizzle: start address, leading
// byte offset (LBO) and stride byte offset (SBO), each in 16-byte units.
// For a K-major operand (a Core tile whose columns are the reduction
// index) LBO is the step between the two core matrices of a 16-deep slice
// (128 bytes) and SBO the step between 8-row groups; for an MN-major B
// (the reduction index runs down the rows) LBO is the step between 8-row
// groups and SBO the step between core matrices along the columns.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

// The same for a tile that TMA wrote with 128-byte swizzle (rows of 128
// bytes, 8-row groups of 1024 bytes, 1024-byte aligned): K-major operands
// step 32 bytes per 16-deep slice, MN-major ones 2048; SBO is the 8-row
// group's 1024 bytes either way.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that own them.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Accumulators of m64nNk16 (N/2 floats a thread): warp w of the warpgroup
// holds rows 16w + g and 16w + g + 8; d[4j + e] is row g + 8 * (e / 2),
// column 8j + 2t + e % 2. A from registers takes the mma.m16n8k16 A
// fragment of the warp's 16 rows.

// d[32] (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A (64x16, shared, K-major) * B (16x128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] (+)= A (64x16, registers) * B (16x32, shared, MN-major); d = A B
// where accumulate is 0, as for the products below
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[32] (+)= A (64x16, registers) * B (16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[40] (+)= A (64x16, registers) * B (16x80, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39 "
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[64] (+)= A (64x16, registers) * B (16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The products by width: wgmma_ss<N> for N in {64, 128}, wgmma_rs<N> for N
// in {32, 64, 80, 128}.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    static_assert(N == 128, "wgmma_ss: N 64 or 128");
    wgmma_ss_n128(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate = 1) {
  if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db, accumulate);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db, accumulate);
  } else if constexpr (N == 80) {
    wgmma_rs_n80(d, a, db, accumulate);
  } else {
    static_assert(N == 128, "wgmma_rs: N 32, 64, 80 or 128");
    wgmma_rs_n128(d, a, db, accumulate);
  }
}

}  // namespace
