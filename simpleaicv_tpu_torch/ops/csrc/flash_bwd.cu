// Flash attention backward for Hopper (sm_90a): two kernels that replace the
// Pallas kernels simpleaicv_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (the FlashAttention-2 backward).
//
// From q, k, v, dO [B, H, N, d], the forward's row logsumexp lse and
// delta = rowsum(dO * o) (both f32, [B*H, N]) they recompute
//   p  = exp(d^-0.5 * q k^T - lse)        (keys past N give p = 0)
//   ds = p * (dO v^T - delta)
// and accumulate
//   flash_dq:   dq = d^-0.5 * ds k        one block per 64 queries, over keys
//   flash_dkv:  dv = p^T dO               one block per 64 keys, over queries
//               dk = d^-0.5 * ds^T q
// Each block owns its output rows, so there are no atomics and the result is
// deterministic. p is rounded to bf16 before p^T dO and ds before the dq and
// dk products, where the JAX backward rounds them.
//
// Bound: at ViT-B/16 batch 128 (BH 1536, N 197, d 64, bf16) dq does 22.9
// GFLOP over 196 MB and dkv 30.5 GFLOP over 235 MB, so both are bound by
// bytes; the [N, N] probabilities never reach device memory and every tensor
// is read in place through its strides. All products run on the tensor cores
// (mma.sync m16n8k16, f32 accumulators) 16 keys or queries at a time, so the
// score tiles live in 16 registers per lane. flash_dkv computes the
// transposed tiles (keys x queries) directly, which makes its accumulators
// the A operand of both of its output products. The f32 kernels are plain
// FMA loops kept for full-precision checks. Loads are not pipelined yet.
//
// Plain C interface, loaded with ctypes; the caller passes PyTorch's current
// stream and element strides (unit stride over d).

#include "flash_mma.cuh"

namespace {

constexpr int kBlock = 64;  // output rows per thread block
constexpr int kTile = 64;   // rows of the other side per shared-memory tile

// Block: 64 queries, 4 warps of 16 query rows; lane (g, t) owns rows g and
// g+8 of its warp.
template <int D_PAD>
__global__ void __launch_bounds__(128)
flash_dq_bf16(View q, View k, View v, View dout,
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
flash_dkv_bf16(View q, View k, View v, View dout,
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

template <int D_PAD>
void launch_dq(bool bf16, dim3 grid, cudaStream_t st, View q, View k, View v,
               View dout, const float* lse, const float* delta, View dq,
               int heads, int n, int d, float scale) {
  if (bf16)
    flash_dq_bf16<D_PAD><<<grid, 128, 0, st>>>(q, k, v, dout, lse, delta, dq,
                                               heads, n, d, scale);
  else
    flash_dq_f32<D_PAD><<<grid, kBlock, 0, st>>>(q, k, v, dout, lse, delta,
                                                 dq, heads, n, d, scale);
}

template <int D_PAD>
void launch_dkv(bool bf16, dim3 grid, cudaStream_t st, View q, View k, View v,
                View dout, const float* lse, const float* delta, View dk,
                View dv, int heads, int n, int d, float scale) {
  if (bf16)
    flash_dkv_bf16<D_PAD><<<grid, 128, 0, st>>>(q, k, v, dout, lse, delta, dk,
                                                dv, heads, n, d, scale);
  else
    flash_dkv_f32<D_PAD><<<grid, kBlock, 0, st>>>(q, k, v, dout, lse, delta,
                                                  dk, dv, heads, n, d, scale);
}

bool bad_shape(int batch, int heads, int n, int d, int is_bf16) {
  return batch < 1 || heads < 1 || n < 1 || d < 1 || d > 128 ||
         (is_bf16 && d % 2 != 0) || (n + kBlock - 1) / kBlock > 65535;
}

}  // namespace

// Each tensor is a pointer followed by its element strides over batch, head
// and token; lse and delta are contiguous [B*H, N] f32. Both functions
// return a cudaError_t: cudaErrorInvalidValue for shapes the kernels do not
// take, else the launch's own status.
extern "C" int flash_dq(const void* q, long long q_sb, long long q_sh,
                        long long q_sn, const void* k, long long k_sb,
                        long long k_sh, long long k_sn, const void* v,
                        long long v_sb, long long v_sh, long long v_sn,
                        const void* dout, long long do_sb, long long do_sh,
                        long long do_sn, void* dq, long long dq_sb,
                        long long dq_sh, long long dq_sn, const void* lse,
                        const void* delta, int batch, int heads, int n, int d,
                        int is_bf16, float scale, void* stream) {
  if (bad_shape(batch, heads, n, d, is_bf16)) return cudaErrorInvalidValue;
  const dim3 grid(batch * heads, (n + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv{q, q_sb, q_sh, q_sn}, kv{k, k_sb, k_sh, k_sn},
      vv{v, v_sb, v_sh, v_sn}, dov{dout, do_sb, do_sh, do_sn},
      dqv{dq, dq_sb, dq_sh, dq_sn};
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d <= 64)
    launch_dq<64>(is_bf16, grid, st, qv, kv, vv, dov, ls, dl, dqv, heads, n,
                  d, scale);
  else if (d <= 80)
    launch_dq<80>(is_bf16, grid, st, qv, kv, vv, dov, ls, dl, dqv, heads, n,
                  d, scale);
  else
    launch_dq<128>(is_bf16, grid, st, qv, kv, vv, dov, ls, dl, dqv, heads, n,
                   d, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (bad_shape(batch, heads, n, d, is_bf16)) return cudaErrorInvalidValue;
  const dim3 grid(batch * heads, (n + kBlock - 1) / kBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const View qv{q, q_sb, q_sh, q_sn}, kv{k, k_sb, k_sh, k_sn},
      vv{v, v_sb, v_sh, v_sn}, dov{dout, do_sb, do_sh, do_sn},
      dkv{dk, dk_sb, dk_sh, dk_sn}, dvv{dv, dv_sb, dv_sh, dv_sn};
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (d <= 64)
    launch_dkv<64>(is_bf16, grid, st, qv, kv, vv, dov, ls, dl, dkv, dvv,
                   heads, n, d, scale);
  else if (d <= 80)
    launch_dkv<80>(is_bf16, grid, st, qv, kv, vv, dov, ls, dl, dkv, dvv,
                   heads, n, d, scale);
  else
    launch_dkv<128>(is_bf16, grid, st, qv, kv, vv, dov, ls, dl, dkv, dvv,
                    heads, n, d, scale);
  return static_cast<int>(cudaGetLastError());
}
