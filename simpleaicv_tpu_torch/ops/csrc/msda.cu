// Multi-scale deformable attention on Hopper (sm_90a), f32: the forward
// (K7) and its backward (K7b).
//
// Replaces simpleaicv_tpu/ops/msda_pallas.py::_msda_kernel (the Pallas
// forward) and the autodiff of simpleaicv_tpu/ops/msda.py::
// ms_deform_attn_xla, which gave the gradients on the TPU; the Pallas kernel
// had no backward. Semantics are ms_deform_attn_xla's: per (batch, query,
// head) L levels x P points of bilinear samples from the flattened value
// table, align_corners=False (pixel centres at (i + 0.5) / size), zero
// padding outside the level, weighted by the attention weights and summed
// in f32.
//
// Layouts (all contiguous f32):
//   value [B, S, H, D]; loc [B, Lq, H, L, P, 2] in [0, 1] (x, y);
//   attw [B, Lq, H, L, P]; out and grad_out [B, Lq, H * D];
//   grad_value [B, S, H, D] (zeroed by the caller), grad_loc like loc,
//   grad_attw like attw.
//
// Mapping: one warp per (b, q, h), lane = channel d (a second channel per
// lane for 32 < D <= 64). For each sample the warp reads the location and
// the weight (one address for all lanes, a broadcast) and the four corner
// rows value[b, start_l + yi * w_l + xi, h, :], each D contiguous floats:
// 128 coalesced bytes at DINO-DETR's D = 32. A corner outside the level
// reads as 0.
//
// Bounds (H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): both kernels do a few
// operations per byte and are bound by bytes. The forward moves value,
// loc, attw and out once at best; the gathers re-read value rows through
// L2, where neighbouring queries share them. The backward adds each
// corner's share of grad_out into grad_value with f32 atomics (4 x D per
// sample: 3.6 G adds at DINO-DETR's encoder launch at batch 2), reduces
// the weight and the two location gradients over the warp with shuffles,
// and is bound by the atomics' traffic through L2. A faster reduction
// (vector red, staging in shared memory, a sort by row) is later work.
// The order of the atomic adds changes from run to run, so grad_value is
// not bit-reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;  // warps per block
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];  // first row of the level in value
};

// One sample's bilinear setup: the corner offsets (row * H * D, or -1 when
// outside the level) and the fractional parts.
struct Corners {
  long long off[4];  // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  float wx, wy;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int hl, int wl,
                                           long long start,
                                           long long row_stride) {
  Corners c;
  // rounded as PyTorch's separate multiply and subtract are (no fused
  // multiply-add), so that the cell a sample falls in is the plain
  // version's also where x lands on an integer
  const float x = __fsub_rn(__fmul_rn(lx, static_cast<float>(wl)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, static_cast<float>(hl)), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  c.wx = __fsub_rn(x, x0);
  c.wy = __fsub_rn(y, y0);
  // x0 in [-1, w_l) keeps (int)x0 in range; outside it (NaN included) both
  // columns are outside the level
  const bool xok = x0 >= -1.f && x0 < static_cast<float>(wl);
  const bool yok = y0 >= -1.f && y0 < static_cast<float>(hl);
  const int xi = xok ? static_cast<int>(x0) : -2;
  const int yi = yok ? static_cast<int>(y0) : -2;
  const bool xin[2] = {xok && xi >= 0, xok && xi + 1 < wl};
  const bool yin[2] = {yok && yi >= 0, yok && yi + 1 < hl};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
      c.off[dy * 2 + dx] =
          (yin[dy] && xin[dx])
              ? (start + static_cast<long long>(yi + dy) * wl + xi + dx) *
                    row_stride
              : -1;
  return c;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

template <int CPL>  // channels per lane
__global__ void __launch_bounds__(kWarps * 32)
    msda_fwd_kernel(const float* __restrict__ value,
                    const float* __restrict__ loc,
                    const float* __restrict__ attw, float* __restrict__ out,
                    long long n_warps, int S, int H, int D, int Lq, int L,
                    int P, Levels lv) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (warp >= n_warps) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(warp % H);
  const long long b = warp / H / Lq;
  const int lp = L * P;
  const float* locp = loc + warp * lp * 2;
  const float* wp = attw + warp * lp;
  const long long row_stride = static_cast<long long>(H) * D;
  const float* vb = value + b * S * row_stride + static_cast<long long>(h) * D;

  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    const long long start = lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const Corners cr = corners(__ldg(locp + 2 * i), __ldg(locp + 2 * i + 1),
                                 hl, wl, start, row_stride);
      const float a = __ldg(wp + i);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = lane + 32 * c;
        if (d >= D) break;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = cr.off[k] >= 0 ? __ldg(vb + cr.off[k] + d) : 0.f;
        const float top = v[0] * (1.f - cr.wx) + v[1] * cr.wx;
        const float bot = v[2] * (1.f - cr.wx) + v[3] * cr.wx;
        acc[c] += (top * (1.f - cr.wy) + bot * cr.wy) * a;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int d = lane + 32 * c;
    if (d < D) out[warp * D + d] = acc[c];
  }
}

template <int CPL>
__global__ void __launch_bounds__(kWarps * 32)
    msda_bwd_kernel(const float* __restrict__ value,
                    const float* __restrict__ loc,
                    const float* __restrict__ attw,
                    const float* __restrict__ grad_out,
                    float* __restrict__ grad_value,
                    float* __restrict__ grad_loc,
                    float* __restrict__ grad_attw, long long n_warps, int S,
                    int H, int D, int Lq, int L, int P, Levels lv) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (warp >= n_warps) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(warp % H);
  const long long b = warp / H / Lq;
  const int lp = L * P;
  const float* locp = loc + warp * lp * 2;
  const float* wp = attw + warp * lp;
  const long long row_stride = static_cast<long long>(H) * D;
  const long long head = b * S * row_stride + static_cast<long long>(h) * D;
  const float* vb = value + head;
  float* gvb = grad_value + head;

  float g[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int d = lane + 32 * c;
    g[c] = d < D ? grad_out[warp * D + d] : 0.f;
  }

#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= L) break;
    const int hl = lv.h[l], wl = lv.w[l];
    const long long start = lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const Corners cr = corners(__ldg(locp + 2 * i), __ldg(locp + 2 * i + 1),
                                 hl, wl, start, row_stride);
      const float a = __ldg(wp + i);
      const float cw[4] = {(1.f - cr.wx) * (1.f - cr.wy),
                           cr.wx * (1.f - cr.wy), (1.f - cr.wx) * cr.wy,
                           cr.wx * cr.wy};
      float sw = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = lane + 32 * c;
        if (d >= D) break;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (cr.off[k] >= 0) {
            v[k] = __ldg(vb + cr.off[k] + d);
            atomicAdd(gvb + cr.off[k] + d, a * cw[k] * g[c]);
          } else {
            v[k] = 0.f;
          }
        }
        const float top = v[0] * (1.f - cr.wx) + v[1] * cr.wx;
        const float bot = v[2] * (1.f - cr.wx) + v[3] * cr.wx;
        sw += g[c] * (top * (1.f - cr.wy) + bot * cr.wy);
        // d sample / d wx and / d wy; floor and the inside mask carry no
        // gradient and d wx / d x = 1
        sx += g[c] * ((1.f - cr.wy) * (v[1] - v[0]) + cr.wy * (v[3] - v[2]));
        sy += g[c] * (bot - top);
      }
      sw = warp_sum(sw);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        grad_attw[warp * lp + i] = sw;
        grad_loc[(warp * lp + i) * 2] = wl * a * sx;
        grad_loc[(warp * lp + i) * 2 + 1] = hl * a * sy;
      }
    }
  }
}

// Checks the shapes and fills the level table; returns a CUDA error code.
int levels(int S, int D, int L, int P, const int* shapes, Levels* lv) {
  if (L < 1 || L > kMaxLevels || P < 1 || D < 1 || D > 64)
    return cudaErrorInvalidValue;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    if (lv->h[l] < 1 || lv->w[l] < 1) return cudaErrorInvalidValue;
    lv->start[l] = start;
    start += static_cast<long long>(lv->h[l]) * lv->w[l];
  }
  for (int l = L; l < kMaxLevels; ++l) {
    lv->h[l] = lv->w[l] = 1;
    lv->start[l] = 0;
  }
  return start == S ? cudaSuccess : cudaErrorInvalidValue;
}

unsigned blocks(long long n_warps) {
  return static_cast<unsigned>((n_warps + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// shapes: 2 * L host ints (h_0, w_0, h_1, w_1, ...). Returns 0 or the CUDA
// error of the launch.
int msda_forward(const float* value, const float* loc, const float* attw,
                 float* out, int B, int S, int H, int D, int Lq, int L, int P,
                 const int* shapes, void* stream) {
  Levels lv;
  const int err = levels(S, D, L, P, shapes, &lv);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * Lq * H;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    msda_fwd_kernel<1><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, out, n, S, H, D, Lq, L, P, lv);
  else
    msda_fwd_kernel<2><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, out, n, S, H, D, Lq, L, P, lv);
  return cudaGetLastError();
}

int msda_backward(const float* value, const float* loc, const float* attw,
                  const float* grad_out, float* grad_value, float* grad_loc,
                  float* grad_attw, int B, int S, int H, int D, int Lq, int L,
                  int P, const int* shapes, void* stream) {
  Levels lv;
  const int err = levels(S, D, L, P, shapes, &lv);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * Lq * H;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    msda_bwd_kernel<1><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, grad_out, grad_value, grad_loc, grad_attw, n, S, H,
        D, Lq, L, P, lv);
  else
    msda_bwd_kernel<2><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, grad_out, grad_value, grad_loc, grad_attw, n, S, H,
        D, Lq, L, P, lv);
  return cudaGetLastError();
}

}  // extern "C"
