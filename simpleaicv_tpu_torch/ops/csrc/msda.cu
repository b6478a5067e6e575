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
// The forward (msda_fwd_kernel) and the backward's narrow variant
// (msda_bwd_narrow, the previous backward): one warp per (b, q, h), lane =
// channel d (a second channel per lane for 32 < D <= 64). For each sample
// the warp reads the location and the weight (one address for all lanes, a
// broadcast) and the four corner rows value[b, start_l + yi * w_l + xi, h,
// :], each D contiguous floats: 128 coalesced bytes at DINO-DETR's D = 32.
// A corner outside the level reads as 0. The backward adds each corner's
// share of grad_out into grad_value with scalar f32 atomic adds.
//
// Bounds (H100 SXM, 3.35 TB/s, 67 TFLOP/s f32): the forward moves value,
// loc, attw and out once at best, a few operations per byte; the backward
// also writes grad_value and does 5 operations per inside corner and
// channel and 14 per sample and channel, which bound it (0.43 ms at the
// encoder launch). Both re-read value rows through L2 (128 bytes per inside
// corner: 101 M corners, 13 GB, at DINO-DETR's encoder launch at batch 2),
// and the backward adds the same again into grad_value through L2.
//
// The backward, measured at that launch (NVIDIA H100 80GB HBM3, 700 W;
// perf/msda_split.py, PERF.md): the narrow kernel took 6.75 ms, 5.64
// without its adds (gathers and reductions: one sample's four loads in
// flight per warp), 6.60 with each warp's adds sent to a row of its own (so
// contention costs 0.15 ms). The tiled kernel (msda_bwd_tiled, the path's)
// therefore cuts the gathers' instructions and latency first:
//   - A block of 4 warps owns (b, h, a chunk of consecutive queries), the
//     warps taking the queries in turn, so the block's samples lie close
//     together and their value rows stay in L1; a warp takes up to 8
//     queries, fewer where the launch is small (1 at the decoder's 1,100).
//   - For each (b, q, h) the lanes load the samples' locations and weights
//     once (lane i sample i), then take the samples two at a time: lanes
//     16s + 4k + j hold corner k of sample 2m + s and channel groups j + 4t
//     (16 bytes each), so one warp instruction gathers both samples' eight
//     corner rows, and the next pair's gathers go out before this pair's
//     adds.
//   - grad_value takes 16-byte vector atomic adds (REDG.E.ADD.F32x4), each
//     corner row whole in one instruction (128 bytes at D 32).
//   - The weight and location gradients are reduced over a sample's 16
//     lanes by shuffles in a fixed order and written by its first lane:
//     the same bits on every launch. grad_value's order of adds changes
//     from run to run, as before.
// A first version summed the levels that fit (DINO-DETR's 32x32 and 16x16,
// 160 KB a head) in shared memory and flushed them once. It did not pay:
// f32 atomic adds to shared memory compile to compare-and-swap loops
// (ATOMS.CAST.SPIN in the SASS), and with them the kernel ran slower than
// with every add sent to device memory; 160 KB of shared memory also left
// one block an SM and a smaller L1. The tiled kernel takes 5.43 ms at the
// encoder launch, 3.72 without its adds and 5.11 without its gathers: the
// vector adds' traffic through L2 now bounds it.
// The narrow variant takes what the tiled kernel does not: D no multiple
// of 4, more than 32 samples a (query, head), value not 16-byte or loc not
// 8-byte aligned (ops/msda.py::_msda_bwd_variant; the wrapper copies a
// grad_out that is not 16-byte aligned).
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): msda_bwd_tiled 64, 89 and
// 103 registers for D <= 16, 32 and 64 (128 threads, at least 4, 4 and 2
// blocks an SM), no spills, a 128-byte stack frame (the level table read
// by a runtime index); msda_bwd_narrow 40 and 62, msda_fwd_kernel 32 and 48,
// no spills.

#include <cuda_runtime.h>
#include <stdint.h>

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
    msda_bwd_narrow(const float* __restrict__ value,
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

// --------------------- the backward, tiled (the path's) ---------------------

constexpr int kTiledWarps = 4;   // warps of a tiled block
constexpr int kMaxPerWarp = 8;   // queries a warp of it takes, at most

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// One lane's corner of one sample: its row in value (-1 outside the level),
// the sample's weight and fractional parts, the level's size and the
// corner's CH groups of 4 channels.
template <int CH>
struct Tap {
  int row, hl, wl;
  float a, wx, wy;
  float4 v[CH];
};

// A block owns (batch b, head h, a chunk of consecutive queries), its warps
// taking the queries in turn, so that the block's samples at any moment lie
// close together and their value rows stay in L1. For a (b, q, h) the lanes
// first load the samples' locations and weights (lane i sample i, at most
// 32), then take the samples two at a time: lanes 16s .. 16s + 15 sample
// 2m + s, lane 16s + 4k + j corner k (dy = k / 2, dx = k % 2) and channel
// groups j + 4t (channels 4 (j + 4t) .. + 3) for t < CH, so that a warp's
// 16-byte gathers read both samples' eight corner rows at once, and the
// next pair's gathers go out before this pair's adds. The value gradient
// of the pair's eight corner rows goes into grad_value as 16-byte vector
// adds, each row whole in one instruction (lanes 4 CH r' .. 4 CH r' + 4 CH
// - 1 on row r0 + r', a group of 4 channels each): 128-byte rows at D 32,
// as the narrow kernel's scalar adds come, in a quarter of the
// instructions. The weight and location gradients are reduced over a
// sample's 16 lanes in a fixed order and written by its first lane, so
// they are the same on every launch.
template <int CH>
__global__ void __launch_bounds__(kTiledWarps * 32, CH <= 2 ? 4 : 2)
    msda_bwd_tiled(const float* __restrict__ value,
                   const float* __restrict__ loc,
                   const float* __restrict__ attw,
                   const float* __restrict__ grad_out,
                   float* __restrict__ grad_value,
                   float* __restrict__ grad_loc,
                   float* __restrict__ grad_attw, int S, int H, int D, int Lq,
                   int L, int P, Levels lv, int chunk, int chunks) {
  const int bh = blockIdx.x / chunks;
  const int b = bh / H, h = bh % H;
  const int q_begin = (blockIdx.x % chunks) * chunk;
  const int q_end = min(Lq, q_begin + chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / 16, k = (lane / 4) % 4, j = lane % 4;
  const int dy = k / 2, dx = k % 2;
  const int cc = lane % (4 * CH);  // the lane's group of 4 channels in adds
  const int lp = L * P, pairs = (lp + 1) / 2;
  const long long row_stride = static_cast<long long>(H) * D;
  const long long head = static_cast<long long>(b) * S * row_stride +
                         static_cast<long long>(h) * D;
  const float* vb = value + head;
  float* gvb = grad_value + head;

  // this lane's corner of sample 2m + half, its gathers issued
  auto tap = [&](int m, float lx, float ly, float al, Tap<CH>& tp) {
    const int i = 2 * m + half;
    const float sx = __shfl_sync(kFull, lx, i & 31);
    const float sy = __shfl_sync(kFull, ly, i & 31);
    tp.a = __shfl_sync(kFull, al, i & 31);
    const int l = min(i, lp - 1) / P;
    tp.hl = lv.h[l];
    tp.wl = lv.w[l];
    // rounded as PyTorch's separate multiply and subtract are (no fused
    // multiply-add), as in corners()
    const float x = __fsub_rn(__fmul_rn(sx, static_cast<float>(tp.wl)), 0.5f);
    const float y = __fsub_rn(__fmul_rn(sy, static_cast<float>(tp.hl)), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    tp.wx = __fsub_rn(x, x0);
    tp.wy = __fsub_rn(y, y0);
    // x0 in [-1, w_l) keeps (int)x0 in range; outside it (NaN included) the
    // corner is outside the level
    const bool xok = x0 >= -1.f && x0 < static_cast<float>(tp.wl);
    const bool yok = y0 >= -1.f && y0 < static_cast<float>(tp.hl);
    const int cx = xok ? static_cast<int>(x0) + dx : -1;
    const int cy = yok ? static_cast<int>(y0) + dy : -1;
    const bool inside =
        i < lp && cx >= 0 && cx < tp.wl && cy >= 0 && cy < tp.hl;
    tp.row = inside ? static_cast<int>(lv.start[l]) + cy * tp.wl + cx : -1;
    const float* vr = vb + static_cast<long long>(tp.row) * row_stride;
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      const int c = 4 * (j + 4 * t);
      tp.v[t] = inside && c < D ? ldg4(vr + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  for (int q = q_begin + warp; q < q_end; q += kTiledWarps) {
    const long long bqh = (static_cast<long long>(b) * Lq + q) * H + h;
    float lx = 0.f, ly = 0.f, al = 0.f;  // sample `lane`
    if (lane < lp) {
      const float2 xy =
          __ldg(reinterpret_cast<const float2*>(loc) + bqh * lp + lane);
      lx = xy.x;
      ly = xy.y;
      al = __ldg(attw + bqh * lp + lane);
    }
    float4 g[CH];  // the channels of the lane's corner groups
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      const int c = 4 * (j + 4 * t);
      g[t] = c < D ? ldg4(grad_out + bqh * D + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // and those of its group in the adds
    const float4 ga = 4 * cc < D ? ldg4(grad_out + bqh * D + 4 * cc)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);

    Tap<CH> cur, next;
    tap(0, lx, ly, al, cur);
    for (int m = 0; m < pairs; ++m) {
      if (m + 1 < pairs) tap(m + 1, lx, ly, al, next);
      const int i = 2 * m + half;
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < CH; ++t)
        dot += g[t].x * cur.v[t].x + g[t].y * cur.v[t].y +
               g[t].z * cur.v[t].z + g[t].w * cur.v[t].w;
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      // the four corners' g . v, each summed over the channels
      const float d0 = __shfl_sync(kFull, dot, 16 * half);
      const float d1 = __shfl_sync(kFull, dot, 16 * half + 4);
      const float d2 = __shfl_sync(kFull, dot, 16 * half + 8);
      const float d3 = __shfl_sync(kFull, dot, 16 * half + 12);
      const float ux = 1.f - cur.wx, uy = 1.f - cur.wy;
      if ((lane & 15) == 0 && i < lp) {
        // d sample / d wx and / d wy; floor and the inside mask carry no
        // gradient and d wx / d x = 1
        const float sx = uy * (d1 - d0) + cur.wy * (d3 - d2);
        const float sy = ux * (d2 - d0) + cur.wx * (d3 - d1);
        grad_attw[bqh * lp + i] = ux * uy * d0 + cur.wx * uy * d1 +
                                  ux * cur.wy * d2 + cur.wx * cur.wy * d3;
        reinterpret_cast<float2*>(grad_loc)[bqh * lp + i] = make_float2(
            cur.wl * cur.a * sx, cur.hl * cur.a * sy);
      }
      // f = a * the corner's bilinear weight; row r of the pair (sample
      // r / 4, corner r % 4) is held by lane 4r
      const float f = cur.a * ((dx ? cur.wx : ux) * (dy ? cur.wy : uy));
#pragma unroll
      for (int r0 = 0; r0 < 8; r0 += 8 / CH) {
        const int r = r0 + lane / (4 * CH);
        const int row = __shfl_sync(kFull, cur.row, 4 * r);
        const float fr = __shfl_sync(kFull, f, 4 * r);
        if (row >= 0 && 4 * cc < D)
          atomicAdd(reinterpret_cast<float4*>(
                        gvb + static_cast<long long>(row) * row_stride +
                        4 * cc),
                    make_float4(fr * ga.x, fr * ga.y, fr * ga.z, fr * ga.w));
      }
      cur = next;
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

// The queries a tiled block owns: each warp takes as many as keep about
// four rounds of the card's resident warps busy, at most kMaxPerWarp (8 at
// DINO-DETR's encoder launch, where consecutive queries share value rows in
// L1; 1 at its decoder launch of 1,100 queries, where there are few).
template <int CH>
cudaError_t launch_tiled(const float* value, const float* loc,
                         const float* attw, const float* grad_out,
                         float* grad_value, float* grad_loc, float* grad_attw,
                         int B, int S, int H, int D, int Lq, int L, int P,
                         const Levels& lv, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long rounds = static_cast<long long>(sms) * 32 * 4;  // warps
  const long long per_warp = static_cast<long long>(B) * H * Lq / rounds;
  const int chunk =
      kTiledWarps * static_cast<int>(per_warp < 1             ? 1
                                     : per_warp > kMaxPerWarp ? kMaxPerWarp
                                                              : per_warp);
  const int chunks = (Lq + chunk - 1) / chunk;
  if (static_cast<long long>(B) * H * chunks >= (1LL << 31))
    return cudaErrorInvalidValue;
  msda_bwd_tiled<CH><<<B * H * chunks, kTiledWarps * 32, 0, st>>>(
      value, loc, attw, grad_out, grad_value, grad_loc, grad_attw, S, H, D, Lq,
      L, P, lv, chunk, chunks);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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

// The tiled kernel: D a multiple of 4 up to 64, at most 32 samples a
// (query, head), value, grad_out and grad_value 16-byte aligned and loc
// 8-byte aligned; cudaErrorInvalidValue for anything else (the narrow
// kernel below takes it).
int msda_backward(const float* value, const float* loc, const float* attw,
                  const float* grad_out, float* grad_value, float* grad_loc,
                  float* grad_attw, int B, int S, int H, int D, int Lq, int L,
                  int P, const int* shapes, void* stream) {
  Levels lv;
  const int err = levels(S, D, L, P, shapes, &lv);
  if (err != cudaSuccess) return err;
  if (D % 4 != 0 || L * P > 32 || !aligned(value, 16) ||
      !aligned(grad_out, 16) || !aligned(grad_value, 16) || !aligned(loc, 8))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * Lq * H == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_tiled<1>(value, loc, attw, grad_out, grad_value, grad_loc,
                           grad_attw, B, S, H, D, Lq, L, P, lv, st);
  if (D <= 32)
    return launch_tiled<2>(value, loc, attw, grad_out, grad_value, grad_loc,
                           grad_attw, B, S, H, D, Lq, L, P, lv, st);
  return launch_tiled<4>(value, loc, attw, grad_out, grad_value, grad_loc,
                         grad_attw, B, S, H, D, Lq, L, P, lv, st);
}

int msda_backward_narrow(const float* value, const float* loc,
                         const float* attw, const float* grad_out,
                         float* grad_value, float* grad_loc, float* grad_attw,
                         int B, int S, int H, int D, int Lq, int L, int P,
                         const int* shapes, void* stream) {
  Levels lv;
  const int err = levels(S, D, L, P, shapes, &lv);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * Lq * H;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    msda_bwd_narrow<1><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, grad_out, grad_value, grad_loc, grad_attw, n, S, H,
        D, Lq, L, P, lv);
  else
    msda_bwd_narrow<2><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, grad_out, grad_value, grad_loc, grad_attw, n, S, H,
        D, Lq, L, P, lv);
  return cudaGetLastError();
}

}  // extern "C"
