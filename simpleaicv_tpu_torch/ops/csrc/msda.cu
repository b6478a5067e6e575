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
// The narrow variants (msda_fwd_narrow and msda_bwd_narrow, the first
// forward and backward): one warp per (b, q, h), lane = channel d (a second
// channel per lane for 32 < D <= 64). For each sample
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
// The forward, split the same way before its redesign (perf/msda_split.py
// at the encoder launch): the narrow kernel took 4.21 ms, 3.74
// without its gathers. It was bound by its instructions, not its gathers:
// each of a warp's 32 lanes worked out every sample's four corners, one
// sample at a time. The tiled forward (msda_fwd_tiled, the path's) takes
// the backward's gather plan and then cuts the instructions a pair of
// samples costs:
//   - A block of 8 warps owns (b, h, a patch of queries): 8 x 8 cells of one
//     level where the queries are the levels' cells (Lq == S, DINO-DETR's
//     encoder), else a run of consecutive queries as the backward's chunks;
//     its warps take the queries in turn.
//   - Lanes 16s + 4k + j hold corner k of sample 2m + s and channel groups
//     j + 4t, two samples' eight corner rows a 16-byte gather instruction;
//     the next pair's gathers (the next query's first pair after a query's
//     last) go out before this pair's blend, which needs no shuffle.
//   - A corner's cell, row and weight are worked out in f32 from a table of
//     each sample's level (w, h, first row) in shared memory, one conversion
//     to an integer a corner, and its offset in 32 bits; no division by P.
//   - A query's sums are reduced over the lanes by shuffles in a fixed
//     order: the same bits on every launch.
// Levels served from shared memory (DINO-DETR's 32x32 and 16x16, 160 KB a
// head, loaded by TMA into a persistent block an SM) were built and
// measured slower at both DINO-DETR launches: the kernel is bound by its
// instructions, and one 16-warp block an SM hid less latency. They went.
// The tiled forward takes 1.85 ms, 1.55 without its gathers and 1.91
// walking runs of queries instead of patches of cells (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
// The forward's narrow variant takes D no multiple of 4, more than 32
// samples a (query, head), value not 16-byte or loc not 8-byte aligned,
// S from 2^24 or S H D from 2^31 (ops/msda.py::_msda_fwd_variant).
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): msda_fwd_tiled 63, 72 and
// 106 registers for D <= 16, 32 and 64 (256 threads, at least 3, 3 and 2
// blocks an SM), 512 bytes of shared memory; msda_bwd_tiled 64, 91 and 103
// (128 threads, at least 4, 4 and 2 blocks an SM); msda_bwd_narrow 40 and
// 56, msda_fwd_narrow 32 and 48; no spills.

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
    msda_fwd_narrow(const float* __restrict__ value,
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

// --------------------- the forward, tiled (the path's) ---------------------

constexpr int kFwdWarps = 8;      // warps of a tiled forward block

__device__ __forceinline__ void fma4(float4& acc, float f, const float4& v) {
  acc.x = fmaf(f, v.x, acc.x);
  acc.y = fmaf(f, v.y, acc.y);
  acc.z = fmaf(f, v.z, acc.z);
  acc.w = fmaf(f, v.w, acc.w);
}

// One lane's corner of one sample in the forward: the sample's weight times
// the corner's bilinear weight (0 outside the level) and the corner's CH
// groups of 4 channels.
template <int CH>
struct FwdTap {
  float f;
  float4 v[CH];
};

// The queries a forward block takes: a patch of `rows` x `cols` queries,
// query q0 + r * stride + c for r < rows and c < cols (a run of
// consecutive queries has rows 1), numbered i = r * width + c.
struct Patch {
  int q0, stride, width, rows, cols;
  // the query of item i, or -1 where the patch has none
  __device__ __forceinline__ int query(int i) const {
    const int r = i / width, c = i - r * width;
    return r < rows && c < cols ? q0 + r * stride + c : -1;
  }
};

// The forward for the queries of items i_first, i_first + i_step, ... <
// i_end of a patch of (batch b, head h), by one warp. Lanes 16s + 4k + j
// hold corner k (dy = k / 2, dx = k % 2) of sample 2m + s and channel
// groups j + 4t for t < CH (16 bytes each), so that a warp instruction
// gathers two samples' eight corner rows. The samples' locations and
// weights are loaded once a query (lane i sample i) and the next query's
// while this one runs; the next pair's gathers (the next query's first
// pair after the last) go out before this pair's blend. Each lane sums f *
// v over its pairs in f32; a query ends with a sum over the lanes of each
// channel group (shuffles over k and s in a fixed order, so the output has
// the same bits on every launch) and 16-byte stores. `smp[i]` holds the
// (w, h, first row) of sample i's level as floats, exact below 2^24, in
// shared memory: a corner's row is found in f32 with one conversion at the
// end, and its offset in a batch of value in 32 bits (fewer than 2^31
// floats).
template <int CH>
__device__ __forceinline__ void fwd_queries(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attw, float* __restrict__ out, int S, int H,
    int D, int Lq, int lp, const float4* smp, int b, int h,
    const Patch& patch, int i_first, int i_end, int i_step) {
  const int lane = threadIdx.x % 32;
  const int half = lane / 16, k = (lane / 4) % 4, j = lane % 4;
  const float dx = static_cast<float>(k % 2), dy = static_cast<float>(k / 2);
  const int pairs = (lp + 1) / 2;
  // head h's channels of batch b, 4 floats an element: row r's group g at
  // vb[r * row_stride + g]
  const unsigned row_stride = H * D / 4;
  const float4* vb = reinterpret_cast<const float4*>(
      value + (static_cast<long long>(b) * S * H + h) * D);
  // the corner's bilinear weight along x is fma(kx, wx, bx): wx for dx 1,
  // 1 - wx (one rounding either way) for dx 0; the same along y
  const float kx = 2.f * dx - 1.f, bx = 1.f - dx;
  const float ky = 2.f * dy - 1.f, by = 1.f - dy;

  // sample `lane` of query qq (zeros for no query or past the samples)
  auto samples = [&](int qq, float& lx, float& ly, float& al) {
    lx = ly = al = 0.f;
    if (qq >= 0 && lane < lp) {
      const long long bqh = (static_cast<long long>(b) * Lq + qq) * H + h;
      const float2 xy =
          __ldg(reinterpret_cast<const float2*>(loc) + bqh * lp + lane);
      lx = xy.x;
      ly = xy.y;
      al = __ldg(attw + bqh * lp + lane);
    }
  };
  // this lane's corner of sample i, its gathers issued
  auto tap = [&](int i, float lx, float ly, float al, FwdTap<CH>& tp) {
    const float sx = __shfl_sync(kFull, lx, i & 31);
    const float sy = __shfl_sync(kFull, ly, i & 31);
    const float a = __shfl_sync(kFull, al, i & 31);
    const float4 lev = smp[i & 31];  // w, h, first row of its level
    // rounded as PyTorch's separate multiply and subtract are (no fused
    // multiply-add), as in corners()
    const float x = __fsub_rn(__fmul_rn(sx, lev.x), 0.5f);
    const float y = __fsub_rn(__fmul_rn(sy, lev.y), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
    // the corner's cell; false for NaN and infinities
    const float cx = x0 + dx, cy = y0 + dy;
    const bool inside = i < lp && cx >= 0.f && cx < lev.x && cy >= 0.f &&
                        cy < lev.y;
    const unsigned row = __float2uint_rz(fmaf(cy, lev.x, cx) + lev.z);
    tp.f = inside ? a * (fmaf(kx, wx, bx) * fmaf(ky, wy, by)) : 0.f;
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      const unsigned g = j + 4 * t;
      tp.v[t] = inside && 4 * g < D ? __ldg(vb + (row * row_stride + g))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float4 acc[CH];
#pragma unroll
  for (int t = 0; t < CH; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the items of the patch that hold queries, in turn
  auto next_item = [&](int i) {
    for (; i < i_end; i += i_step)
      if (patch.query(i) >= 0) return i;
    return i_end;
  };
  int i = next_item(i_first);
  if (i >= i_end) return;
  int q = patch.query(i);
  int i_next = next_item(i + i_step);
  int q_next = i_next < i_end ? patch.query(i_next) : -1;
  float lx, ly, al, nx, ny, na;
  samples(q, lx, ly, al);
  samples(q_next, nx, ny, na);
  int m = 0;
  // pair m of query q: fetches the next pair into `fetch`, blends `use`
  // and, after the query's last pair, stores the query; false when the
  // warp's queries are done
  auto stage = [&](const FwdTap<CH>& use, FwdTap<CH>& fetch) {
    const bool last = m + 1 == pairs;
    if (!last)
      tap(2 * (m + 1) + half, lx, ly, al, fetch);
    else if (q_next >= 0)
      tap(half, nx, ny, na, fetch);
#pragma unroll
    for (int t = 0; t < CH; ++t) fma4(acc[t], use.f, use.v[t]);
    if (!last) {
      ++m;
      return true;
    }
    // channel group j + 4t summed over the lanes of the same j
#pragma unroll
    for (int t = 0; t < CH; ++t) {
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        acc[t].x += __shfl_xor_sync(kFull, acc[t].x, s);
        acc[t].y += __shfl_xor_sync(kFull, acc[t].y, s);
        acc[t].z += __shfl_xor_sync(kFull, acc[t].z, s);
        acc[t].w += __shfl_xor_sync(kFull, acc[t].w, s);
      }
    }
    if (lane < 4) {
      const long long bqh = (static_cast<long long>(b) * Lq + q) * H + h;
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int c = 4 * (j + 4 * t);
        if (c < D) *reinterpret_cast<float4*>(out + bqh * D + c) = acc[t];
      }
    }
#pragma unroll
    for (int t = 0; t < CH; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_next < 0) return false;
    q = q_next;
    i_next = next_item(i_next + i_step);
    q_next = i_next < i_end ? patch.query(i_next) : -1;
    lx = nx;
    ly = ny;
    al = na;
    samples(q_next, nx, ny, na);
    m = 0;
    return true;
  };
  // the taps alternate between two buffers, so that no pair is copied
  FwdTap<CH> a, c;
  tap(half, lx, ly, al, a);
  while (stage(a, c) && stage(c, a)) {
  }
}

constexpr int kCell = 8;  // a patch of the cell walk: kCell x kCell cells

// A block per (b, h, patch of queries), its warps taking the patch's
// queries in turn, so that the block's samples at any moment lie close
// together and their value rows stay in L1. Where the queries are the
// levels' cells (Lq == S, as in DINO-DETR's encoder: query start_l + y w_l
// + x samples around cell (y, x) of level l), a patch is kCell x kCell
// cells of one level (`cells` the launch's patches), whose queries share
// more value rows than a run of as many cells of one row, as each query's
// samples reach a few cells around it; else it is `chunk` consecutive
// queries (cells 0).
template <int CH>
__global__ void __launch_bounds__(kFwdWarps * 32, CH <= 2 ? 3 : 2)
    msda_fwd_tiled(const float* __restrict__ value,
                   const float* __restrict__ loc,
                   const float* __restrict__ attw, float* __restrict__ out,
                   int S, int H, int D, int Lq, int L, int P,
                   const __grid_constant__ Levels lv, int chunk, int chunks,
                   int cells) {
  Patch patch;
  int bh, items;
  if (cells > 0) {
    bh = blockIdx.x / cells;
    int t = blockIdx.x % cells, l = 0;
    for (; l < L - 1; ++l) {
      const int n = ((lv.h[l] + kCell - 1) / kCell) *
                    ((lv.w[l] + kCell - 1) / kCell);
      if (t < n) break;
      t -= n;
    }
    const int across = (lv.w[l] + kCell - 1) / kCell;
    const int y0 = (t / across) * kCell, x0 = (t % across) * kCell;
    patch = {static_cast<int>(lv.start[l]) + y0 * lv.w[l] + x0, lv.w[l],
             kCell, min(kCell, lv.h[l] - y0), min(kCell, lv.w[l] - x0)};
    items = kCell * kCell;
  } else {
    bh = blockIdx.x / chunks;
    const int q0 = (blockIdx.x % chunks) * chunk;
    patch = {q0, 0, chunk, 1, min(chunk, Lq - q0)};
    items = chunk;
  }
  // sample i's level: (w, h, first row)
  __shared__ float4 smp[32];
  if (threadIdx.x < 32) {
    const int l = min(static_cast<int>(threadIdx.x), L * P - 1) / P;
    smp[threadIdx.x] = make_float4(static_cast<float>(lv.w[l]),
                                   static_cast<float>(lv.h[l]),
                                   static_cast<float>(lv.start[l]), 0.f);
  }
  __syncthreads();
  fwd_queries<CH>(value, loc, attw, out, S, H, D, Lq, L * P, smp, bh / H,
                  bh % H, patch, threadIdx.x / 32, items, kFwdWarps);
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

// The queries a tiled block of `warps` warps owns: each warp takes as many
// as keep about four rounds of the card's resident warps busy, at most
// kMaxPerWarp (8 at DINO-DETR's encoder launch, where consecutive queries
// share value rows in L1; 1 at its decoder launch of 1,100 queries, where
// there are few).
cudaError_t chunk_queries(int warps, int B, int H, int Lq, int* chunk) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long rounds = static_cast<long long>(sms) * 32 * 4;  // warps
  const long long per_warp = static_cast<long long>(B) * H * Lq / rounds;
  *chunk = warps * static_cast<int>(per_warp < 1             ? 1
                                    : per_warp > kMaxPerWarp ? kMaxPerWarp
                                                             : per_warp);
  return cudaSuccess;
}

template <int CH>
cudaError_t launch_tiled(const float* value, const float* loc,
                         const float* attw, const float* grad_out,
                         float* grad_value, float* grad_loc, float* grad_attw,
                         int B, int S, int H, int D, int Lq, int L, int P,
                         const Levels& lv, cudaStream_t st) {
  int chunk = 0;
  const cudaError_t err = chunk_queries(kTiledWarps, B, H, Lq, &chunk);
  if (err != cudaSuccess) return err;
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

// The forward: patches of kCell x kCell cells where the queries are the
// levels' cells (Lq == S), else runs of consecutive queries as the
// backward's chunks.
template <int CH>
cudaError_t launch_fwd_tiled(const float* value, const float* loc,
                             const float* attw, float* out, int B, int S,
                             int H, int D, int Lq, int L, int P,
                             const Levels& lv, cudaStream_t st) {
  const bool cell_walk = Lq == S;
  int cells = 0;
  for (int l = 0; cell_walk && l < L; ++l)
    cells += ((lv.h[l] + kCell - 1) / kCell) * ((lv.w[l] + kCell - 1) / kCell);
  int chunk = 0;
  const cudaError_t err = chunk_queries(kFwdWarps, B, H, Lq, &chunk);
  if (err != cudaSuccess) return err;
  const int chunks = (Lq + chunk - 1) / chunk;
  const long long blocks =
      static_cast<long long>(B) * H * (cell_walk ? cells : chunks);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  msda_fwd_tiled<CH><<<static_cast<unsigned>(blocks), kFwdWarps * 32, 0,
                       st>>>(value, loc, attw, out, S, H, D, Lq, L, P, lv,
                             chunk, chunks, cells);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// shapes: 2 * L host ints (h_0, w_0, h_1, w_1, ...). Returns 0 or the CUDA
// error of the launch.
//
// The tiled forward: D a multiple of 4 up to 64, at most 32 samples a
// (query, head), S below 2^24 and S H D below 2^31, value and out 16-byte
// aligned and loc 8-byte aligned; cudaErrorInvalidValue for anything else
// (msda_forward_narrow takes it).
int msda_forward(const float* value, const float* loc, const float* attw,
                 float* out, int B, int S, int H, int D, int Lq, int L, int P,
                 const int* shapes, void* stream) {
  Levels lv;
  const int err = levels(S, D, L, P, shapes, &lv);
  if (err != cudaSuccess) return err;
  if (D % 4 != 0 || L * P > 32 || !aligned(value, 16) || !aligned(out, 16) ||
      !aligned(loc, 8) || S >= (1 << 24) ||
      static_cast<long long>(S) * H * D >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * Lq * H == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch_fwd_tiled<1>(value, loc, attw, out, B, S, H, D, Lq, L, P,
                               lv, st);
  if (D <= 32)
    return launch_fwd_tiled<2>(value, loc, attw, out, B, S, H, D, Lq, L, P,
                               lv, st);
  return launch_fwd_tiled<4>(value, loc, attw, out, B, S, H, D, Lq, L, P, lv,
                             st);
}

// The forward's narrow variant: any D up to 64, any number of samples,
// 4-byte aligned tensors.
int msda_forward_narrow(const float* value, const float* loc,
                        const float* attw, float* out, int B, int S, int H,
                        int D, int Lq, int L, int P, const int* shapes,
                        void* stream) {
  Levels lv;
  const int err = levels(S, D, L, P, shapes, &lv);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * Lq * H;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    msda_fwd_narrow<1><<<blocks(n), kWarps * 32, 0, st>>>(
        value, loc, attw, out, n, S, H, D, Lq, L, P, lv);
  else
    msda_fwd_narrow<2><<<blocks(n), kWarps * 32, 0, st>>>(
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
