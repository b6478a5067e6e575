// Flash attention forward for Hopper (sm_90a). Replaces the Pallas kernel
// simpleaicv_tpu/ops/flash_attention.py::_fwd_kernel.
//
// For q, k, v [B, H, N, d] (any N) it computes
//   s   = d^-0.5 * q k^T
//   o   = softmax(s) v            (in q's dtype)
//   lse = rowmax + log(rowsum)    (f32, [B*H, N])
// with an online softmax over 64-key tiles, so the [N, N] scores never reach
// device memory. Keys past N score -inf and query rows past N are not
// written, which is what lets ViT's 197 tokens through.
//
// Bound: at ViT-B/16 batch 128 (BH 1536, N 197, d 64, bf16) one call does
// 4*N*N*d*BH = 15.3 GFLOP and moves 156 MB, so it is bound by bytes: every
// input is read from device memory exactly once per query tile that needs
// it, straight from the strided qkv projection (no copy to a contiguous
// layout), and o is written in the [B, N, H, d] layout the output projection
// reads. One block takes 64 queries of one head (4 warps x 16 rows); K and V
// tiles are staged in shared memory and shared by the warps; both products
// run on the tensor cores (mma.sync m16n8k16, f32 accumulators) with the
// probabilities rounded to bf16 in registers. The f32 kernel is a plain FMA
// loop kept for full-precision checks. Loads are not pipelined yet (no
// cp.async / TMA / wgmma).
//
// Plain C interface, loaded with ctypes; the caller passes PyTorch's current
// stream and element strides (unit stride over d).

#include "flash_mma.cuh"

namespace {

constexpr int kBlockQ = 64;  // queries per thread block
constexpr int kTileK = 64;   // keys per shared-memory tile

// Lane (g = lane/4, t = lane%4) owns rows g and g+8 of its warp's 16 query
// rows and, in every 8-wide column tile, columns 2t and 2t+1. d is
// zero-padded to D_PAD (a multiple of 16).
template <int D_PAD>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(View q, View k, View v, View o, float* __restrict__ lse,
               int heads, int n, int d, float scale) {
  constexpr int STR = D_PAD + 8;  // tile row stride: conflict-free reads
  constexpr int NT = kTileK / 8;  // 8-wide key tiles per staged tile
  constexpr int DK = D_PAD / 16;  // 16-deep steps over d
  constexpr int DT = D_PAD / 8;   // 8-wide output tiles over d
  __shared__ __align__(16) __nv_bfloat16 ks[kTileK * STR];
  __shared__ __align__(16) __nv_bfloat16 vs[kTileK * STR];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int row0 = blockIdx.y * kBlockQ + warp * 16 + g;
  const int row1 = row0 + 8;
  const __nv_bfloat16* kh = head_ptr<__nv_bfloat16>(k, bh, heads);
  const __nv_bfloat16* vh = head_ptr<__nv_bfloat16>(v, bh, heads);

  uint32_t qf[DK][4];
  ld_a_global<D_PAD>(qf, head_ptr<__nv_bfloat16>(q, bh, heads), q.sn, row0, n,
                     d, t);

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int key0 = 0; key0 < n; key0 += kTileK) {
    __syncthreads();  // the previous tiles are no longer read
    stage_tile<kTileK, D_PAD, STR, 128>(ks, kh, k.sn, key0, n, d);
    stage_tile<kTileK, D_PAD, STR, 128>(vs, vh, v.sn, key0, n, d);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b0, b1;
        ld_b_rows(b0, b1, ks, STR, nt * 8, kk * 16, g, t);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = key0 + nt * 8 + 2 * t + e < n;
        s[nt][e] = valid ? s[nt][e] * scale : -INFINITY;
        s[nt][2 + e] = valid ? s[nt][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    // the four lanes of a quad hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = expf(s[nt][e] - mn0);
        s[nt][2 + e] = expf(s[nt][2 + e] - mn1);
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
      if (key0 + kk * 16 < n) {  // else the rest of the tile is padding
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          uint32_t b0, b1;
          ld_b_cols(b0, b1, vs, STR, kk * 16, dt * 8, lane);
          mma_bf16(oacc[dt], a, b0, b1);
        }
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* oh = head_ptr<__nv_bfloat16>(o, bh, heads);
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
  if (t == 0) {
    if (row0 < n) lse[(size_t)bh * n + row0] = m0 + logf(l0);
    if (row1 < n) lse[(size_t)bh * n + row1] = m1 + logf(l1);
  }
}

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

template <int D_PAD>
void launch(bool bf16, dim3 grid, cudaStream_t st, View q, View k, View v,
            View o, float* lse, int heads, int n, int d, float scale) {
  if (bf16)
    flash_fwd_bf16<D_PAD><<<grid, 128, 0, st>>>(q, k, v, o, lse, heads, n, d,
                                                scale);
  else
    flash_fwd_f32<D_PAD><<<grid, kBlockQ, 0, st>>>(q, k, v, o, lse, heads, n,
                                                   d, scale);
}

}  // namespace

// Each tensor is a pointer followed by its element strides over batch, head
// and token. Returns a cudaError_t: cudaErrorInvalidValue for shapes the
// kernels do not take, else the launch's own status.
extern "C" int flash_fwd(const void* q, long long q_sb, long long q_sh,
                         long long q_sn, const void* k, long long k_sb,
                         long long k_sh, long long k_sn, const void* v,
                         long long v_sb, long long v_sh, long long v_sn,
                         void* o, long long o_sb, long long o_sh,
                         long long o_sn, void* lse, int batch, int heads,
                         int n, int d, int is_bf16, float scale,
                         void* stream) {
  if (batch < 1 || heads < 1 || n < 1 || d < 1 || d > 128 ||
      (is_bf16 && d % 2 != 0) || (n + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(batch * heads, (n + kBlockQ - 1) / kBlockQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv{q, q_sb, q_sh, q_sn}, kv{k, k_sb, k_sh, k_sn},
      vv{v, v_sb, v_sh, v_sn}, ov{o, o_sb, o_sh, o_sn};
  float* ls = static_cast<float*>(lse);
  if (d <= 64)
    launch<64>(is_bf16, grid, st, qv, kv, vv, ov, ls, heads, n, d, scale);
  else if (d <= 80)
    launch<80>(is_bf16, grid, st, qv, kv, vv, ov, ls, heads, n, d, scale);
  else
    launch<128>(is_bf16, grid, st, qv, kv, vv, ov, ls, heads, n, d, scale);
  return static_cast<int>(cudaGetLastError());
}
