// Flash attention forward with SAM's decomposed relative-position bias, for
// Hopper (sm_90a). Replaces the Pallas kernel
// simpleaicv_tpu/ops/flash_attention.py::_relpos_fwd_kernel.
//
// For q, k, v [BH, N, d], rel_h [BH, N, k_h] f32, rel_w [BH, N, k_w] f32 and
// N = k_h * k_w it computes
//   s[i, j*k_w + c] = d^-0.5 * (q_i . k_{j*k_w+c}) + rel_h[i, j] + rel_w[i, c]
//   o   = softmax(s) v           (in q's dtype)
//   lse = rowmax + log(rowsum)   (f32, [BH, N])
// walking the key grid one row of k_w keys at a time with an online softmax,
// so the [N, N] bias and scores never reach device memory.
//
// Bound: at SAM-B's global layers (BH 12, N 4096, d 64) one call does
// 4*N*N*d*BH = 51.5 GFLOP of matrix products and moves ~50 MB, so it is
// bound by tensor-core operations. The bf16 kernel runs both products on the
// tensor cores (mma.sync m16n8k16, f32 accumulators); K and V of one key row
// are staged in shared memory and shared by the block's four warps. The f32
// kernel is a plain FMA loop, kept for full-precision checks. Neither kernel
// pipelines its loads yet (no cp.async / TMA / wgmma).
//
// Plain C interface, loaded with ctypes; the caller passes contiguous
// tensors and PyTorch's current stream.

#include "flash_mma.cuh"

namespace {

constexpr int kBlockQ = 64;  // queries per thread block

// bf16 kernel. Block: 64 queries, 4 warps of 16 query rows each. Lane
// (g = lane/4, t = lane%4) owns rows g and g+8 of its warp's 16 and, in
// every 8-wide column tile, columns 2t and 2t+1. d is zero-padded to D_PAD
// and the key row to KW_PAD (multiples of 16); padded keys score -inf.
template <int D_PAD, int KW_PAD>
__global__ void __launch_bounds__(128)
relpos_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ rel_h,
                const float* __restrict__ rel_w, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int n, int d, int k_h, int k_w,
                float scale) {
  constexpr int KSTR = D_PAD + 8;   // K tile row stride: conflict-free reads
  constexpr int VSTR = KW_PAD + 8;  // V^T tile row stride
  constexpr int NT = KW_PAD / 8;    // 8-wide key tiles per key row
  constexpr int DK = D_PAD / 16;    // 16-deep steps over d
  constexpr int DT = D_PAD / 8;     // 8-wide output tiles over d
  __shared__ __align__(16) __nv_bfloat16 ks[KW_PAD * KSTR];
  __shared__ __align__(16) __nv_bfloat16 vt[D_PAD * VSTR];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool ok0 = row0 < n, ok1 = row1 < n;
  const size_t base = (size_t)bh * n * d;

  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = (ok0 && c < d) ? ld_pair(q + base + (size_t)row0 * d + c) : 0u;
    qf[kk][1] = (ok1 && c < d) ? ld_pair(q + base + (size_t)row1 * d + c) : 0u;
    qf[kk][2] = (ok0 && c + 8 < d)
                    ? ld_pair(q + base + (size_t)row0 * d + c + 8) : 0u;
    qf[kk][3] = (ok1 && c + 8 < d)
                    ? ld_pair(q + base + (size_t)row1 * d + c + 8) : 0u;
  }

  // rel_w is the same for every key row: keep this lane's columns in
  // registers for the whole walk.
  const float* rw0 = rel_w + ((size_t)bh * n + (ok0 ? row0 : 0)) * k_w;
  const float* rw1 = rel_w + ((size_t)bh * n + (ok1 ? row1 : 0)) * k_w;
  float rw[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + 2 * t + e;
      rw[nt][e] = (ok0 && c < k_w) ? __ldg(rw0 + c) : 0.f;
      rw[nt][2 + e] = (ok1 && c < k_w) ? __ldg(rw1 + c) : 0.f;
    }
  }
  const float* rh0 = rel_h + ((size_t)bh * n + (ok0 ? row0 : 0)) * k_h;
  const float* rh1 = rel_h + ((size_t)bh * n + (ok1 ? row1 : 0)) * k_h;

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < k_h; ++j) {
    __syncthreads();  // the previous row's tiles are no longer read
    const size_t key0 = base + (size_t)j * k_w * d;
    for (int idx = threadIdx.x; idx < KW_PAD * (D_PAD / 2); idx += 128) {
      const int r = idx / (D_PAD / 2), c = (idx % (D_PAD / 2)) * 2;
      uint32_t kp = 0u, vp = 0u;
      if (r < k_w && c < d) {
        kp = ld_pair(k + key0 + (size_t)r * d + c);
        vp = ld_pair(v + key0 + (size_t)r * d + c);
      }
      *reinterpret_cast<uint32_t*>(&ks[r * KSTR + c]) = kp;
      const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(&vp);
      vt[c * VSTR + r] = vv.x;
      vt[(c + 1) * VSTR + r] = vv.y;
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * KSTR + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        mma_bf16(s[nt], qf[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
      }
    }

    const float bh0 = ok0 ? __ldg(rh0 + j) : 0.f;
    const float bh1 = ok1 ? __ldg(rh1 + j) : 0.f;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = nt * 8 + 2 * t + e < k_w;
        s[nt][e] = valid ? s[nt][e] * scale + bh0 + rw[nt][e] : -INFINITY;
        s[nt][2 + e] =
            valid ? s[nt][2 + e] * scale + bh1 + rw[nt][2 + e] : -INFINITY;
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

    // o += p v: the score accumulators of key tiles 2kk and 2kk+1 are, in
    // bf16, exactly the A fragment of a 16-deep step over keys.
#pragma unroll
    for (int kk = 0; kk < KW_PAD / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vr = vt + (dt * 8 + g) * VSTR + kk * 16 + 2 * t;
        mma_bf16(oacc[dt], a, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (c < d) {
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * d + c) =
            __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * d + c) =
            __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
    }
  }
  if (t == 0) {
    if (ok0) lse[(size_t)bh * n + row0] = m0 + logf(l0);
    if (ok1) lse[(size_t)bh * n + row1] = m1 + logf(l1);
  }
}

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

template <int D_PAD, int KW_PAD>
void launch_bf16(dim3 grid, cudaStream_t st, const void* q, const void* k,
                 const void* v, const float* rh, const float* rw, void* o,
                 float* lse, int n, int d, int k_h, int k_w, float scale) {
  relpos_fwd_bf16<D_PAD, KW_PAD><<<grid, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), rh, rw,
      static_cast<__nv_bfloat16*>(o), lse, n, d, k_h, k_w, scale);
}

template <int D_PAD>
void launch_bf16_kw(dim3 grid, cudaStream_t st, const void* q, const void* k,
                    const void* v, const float* rh, const float* rw, void* o,
                    float* lse, int n, int d, int k_h, int k_w, float scale) {
  if (k_w <= 16)
    launch_bf16<D_PAD, 16>(grid, st, q, k, v, rh, rw, o, lse, n, d, k_h, k_w,
                           scale);
  else if (k_w <= 32)
    launch_bf16<D_PAD, 32>(grid, st, q, k, v, rh, rw, o, lse, n, d, k_h, k_w,
                           scale);
  else
    launch_bf16<D_PAD, 64>(grid, st, q, k, v, rh, rw, o, lse, n, d, k_h, k_w,
                           scale);
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

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernels do not
// take, else the launch's own status.
extern "C" int flash_relpos_fwd(const void* q, const void* k, const void* v,
                                const void* rel_h, const void* rel_w, void* o,
                                void* lse, int bh, int n, int d, int k_h,
                                int k_w, int is_bf16, float scale,
                                void* stream) {
  if (bh < 1 || bh > 65535 || k_h < 1 || k_w < 1 || k_w > 64 ||
      k_h * k_w != n || d < 2 || d > 128 || d % 2 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  float* ls = static_cast<float*>(lse);
  if (is_bf16) {
    if (d <= 32)
      launch_bf16_kw<32>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w,
                         scale);
    else if (d <= 64)
      launch_bf16_kw<64>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w,
                         scale);
    else if (d <= 80)
      launch_bf16_kw<80>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w,
                         scale);
    else
      launch_bf16_kw<128>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w,
                          scale);
  } else {
    if (d <= 32)
      launch_f32<32>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
    else if (d <= 64)
      launch_f32<64>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
    else if (d <= 80)
      launch_f32<80>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w, scale);
    else
      launch_f32<128>(grid, st, q, k, v, rh, rw, o, ls, n, d, k_h, k_w,
                      scale);
  }
  return static_cast<int>(cudaGetLastError());
}
