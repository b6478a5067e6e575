"""How close does a hand matrix product come to the library's at ResNet-50's
1x1-convolution shapes (M = batch x H x W)? Counterpart of
``perf/pallas_matmul_probe.py``:

    python -m simpleaicv_tpu_torch.perf.matmul_probe   # on the card

``probe_mm(x, w)`` is P1, ``probe_mm(x, w, stats=True)`` P2, the hand
kernels of ``ops/csrc/probes.cu``: y = x @ w in f32 accumulation stored in
x's dtype (bf16), and with ``stats`` the per-column sum and sum of squares
of the f32 product ([1, N] f32 each), the statistics a fused BatchNorm
epilogue would need. CUDA tensors launch the kernels, both probes by one
rule (``_mm_variant``): a persistent TMA + ``wgmma`` stream (P2's adds the
sums in its epilogue, then a second launch sums the blocks' rows), or for
what the stream does not take the narrow variant, the ``mma.sync`` kernel
of 128 x 64 tiles (``NARROW_LAUNCHES`` counts those launches). CPU tensors
take the plain versions ``mm_plain`` and ``mm_stats_plain``. ``case`` times
a probe beside its plain version, the library calls and its bound;
``variants_ms`` times a probe's stream beside its narrow variant and the
library calls in alternating rounds (P2 also beside P1's stream).
"""

from __future__ import annotations

import ctypes
import functools
import statistics

import torch
import torch.nn.functional as F

from ..ops import _build
from .timing import alternating_ms, bound, cuda_ms

__all__ = ["probe_mm", "mm_plain", "mm_stats_plain", "case", "variants_ms",
           "offset_copy", "LAYERS", "KERNEL_LAUNCHES", "NARROW_LAUNCHES"]

# Launches of each hand kernel since the caller last set the count to 0; the
# wrapper adds one where it launches (P2's two launches count once).
KERNEL_LAUNCHES = {"probe_mm": 0, "probe_mm_stats": 0}
# Those of P1's and P2's launches that took their narrow variant, so that a
# run can show that the probe path took the streams.
NARROW_LAUNCHES = {"probe_mm": 0, "probe_mm_stats": 0}

TILE_M = 128  # rows per block of the narrow variants
ITEM_M = 64   # rows per item of the streams

# name -> (M, K, N, H): ResNet-50 at batch 128, 224^2: layer 1's 1x1
# expansion (56^2, 64 -> 256) and layer 2's (28^2, 128 -> 512)
LAYERS = {"layer1": (128 * 56 * 56, 64, 256, 56),
          "layer2": (128 * 28 * 28, 128, 512, 28)}


def mm_plain(x, w):
    """P1's plain version: the f32 product rounded to x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def mm_stats_plain(x, w):
    """P2's plain version: (y, [1, N] column sums, [1, N] sums of squares),
    the sums of the f32 product."""
    y = x.float() @ w.float()
    return (y.to(x.dtype), y.sum(0, keepdim=True),
            y.square().sum(0, keepdim=True))


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x must be [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the probe is bf16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("probes")
    lib.probe_mm.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p])
    lib.probe_mm.restype = ctypes.c_int
    lib.probe_mm_stream.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.probe_mm_stream.restype = ctypes.c_int
    lib.probe_mm_stats_stream.argtypes = ([ctypes.c_void_p] * 6
                                          + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
    lib.probe_mm_stats_stream.restype = ctypes.c_int
    lib.probe_scale.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_void_p]
    lib.probe_scale.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _mm_variant(x, w) -> str:
    """Which kernel takes P1 or P2 on these inputs, as ``csrc/probes.cu``
    documents: "stream" (the persistent TMA + ``wgmma`` kernel: K 64 or
    128, N a multiple of 64 up to 512, x and w 16-byte aligned) or "narrow"
    (the ``mma.sync`` kernel of 128 x 64 tiles). Depends on the shapes and
    the alignment alone; launches nothing."""
    k, n = w.shape
    if (k in (64, 128) and n % 64 == 0 and 64 <= n <= 512
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "stream"
    return "narrow"


def _mm_cuda(x, w, stats):
    m, k = x.shape
    n = w.shape[1]
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    stream = _mm_variant(x, w) == "stream"
    if not stream:
        if k % 16 or not 16 <= k <= 128 or n % 64 or m > 65535 * TILE_M:
            raise ValueError(f"the kernel takes K in 16..128 in steps of 16, "
                             f"N a multiple of 64 and M up to "
                             f"{65535 * TILE_M}, got M={m} K={k} N={n}")
        if x.data_ptr() % 4 or w.data_ptr() % 16:
            raise ValueError("x must be 4-byte and w 16-byte aligned")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    cuda_stream = torch.cuda.current_stream(x.device).cuda_stream
    name = "probe_mm_stats" if stats else "probe_mm"
    with torch.cuda.device(x.device):
        sums = [None] * 3
        if stats:
            # a row of partial sums a block (the stream's persistent grid:
            # an SM a block, at most one an item; the narrow variant's row
            # tiles), then s1 and s2: one buffer, one allocation
            rows = (min(-(-m // ITEM_M), _sm_count(x.device.index))
                    if stream else -(-m // TILE_M))
            buf = torch.empty((2 * rows + 2, n), dtype=torch.float32,
                              device=x.device)
            s1, s2 = buf[2 * rows:2 * rows + 1], buf[2 * rows + 1:]
            sums = [buf.data_ptr(), s1.data_ptr(), s2.data_ptr()]
        ptrs = (x.data_ptr(), w.data_ptr(), y.data_ptr())
        if not stream:
            err = _lib().probe_mm(*ptrs, *sums, m, k, n, int(stats),
                                  cuda_stream)
        elif stats:
            err = _lib().probe_mm_stats_stream(*ptrs, *sums, rows, m, k, n,
                                               cuda_stream)
        else:
            err = _lib().probe_mm_stream(*ptrs, m, k, n, cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1
    if not stream:
        NARROW_LAUNCHES[name] += 1
    return (y, s1, s2) if stats else y


def probe_mm(x, w, stats: bool = False):
    """x [M, K] @ w [K, N] in bf16 with f32 accumulation -> y [M, N] bf16,
    or with ``stats`` (y, column sums, column sums of squares) of the f32
    product, [1, N] f32 each. CUDA tensors run P1 / P2 (K 16..128 in steps
    of 16, N a multiple of 64, M up to 65535 x 128; any M where the stream
    takes it, ``_mm_variant``), CPU tensors the plain versions."""
    _check(x, w)
    if x.device.type == "cpu":
        return mm_stats_plain(x, w) if stats else mm_plain(x, w)
    return _mm_cuda(x, w, stats)


def probe_inputs(m, k, n, device="cuda", seed=0):
    """x ~ N(0, 1) [M, K] and w ~ N(0, 0.03^2) [K, N], bf16, as the JAX
    probe draws them (from a torch generator here)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    w = (0.03 * torch.randn(k, n, generator=g, device=device)).to(
        torch.bfloat16)
    return x, w


def case(layer: str, stats: bool, iters: int = 50) -> dict:
    """Times P1 (or P2 with ``stats``) at ``LAYERS[layer]`` on the card:
    the kernel, its plain version, the library calls (``torch.matmul``; for
    P1 also the 1x1 ``F.conv2d`` on channels-last NHWC, the JAX probe's
    ``xla_conv``; for P2 the matmul and the two column sums, which are
    three calls, not one) and the bound. Times in ms."""
    m, k, n, h = LAYERS[layer]
    x, w = probe_inputs(m, k, n)
    ms = cuda_ms(lambda: probe_mm(x, w, stats), iters)
    plain = mm_stats_plain if stats else mm_plain
    plain_ms = cuda_ms(lambda: plain(x, w), max(iters // 5, 1))
    matmul_ms = cuda_ms(lambda: torch.matmul(x, w), iters)
    out = {"shape": f"M={m} K={k} N={n} bf16", "ms": ms, "plain_ms": plain_ms}
    if stats:
        out["library_ms"] = cuda_ms(lambda: _stats_library(x, w), iters)
        out["library"] = "torch.matmul, then the two column sums"
    else:
        x4 = x.reshape(m // (h * h), h, h, k).permute(0, 3, 1, 2)
        w4 = w.t().reshape(n, k, 1, 1).contiguous(
            memory_format=torch.channels_last)
        out["conv_ms"] = cuda_ms(lambda: F.conv2d(x4, w4), iters)
        out["library_ms"] = matmul_ms
        out["library"] = "torch.matmul"
    out["matmul_ms"] = matmul_ms
    nbytes = (m * k + k * n + m * n) * 2 + (2 * n * 4 if stats else 0)
    flops = 2.0 * m * k * n + (3.0 * m * n if stats else 0.0)
    out["bound_ms"], out["bound_by"] = bound(flops, nbytes, torch.bfloat16)
    out["bytes"] = nbytes
    out["gbytes_per_s"] = nbytes / ms / 1e6
    return out


def offset_copy(t, offset=2):
    """A copy of ``t`` whose storage starts ``offset`` elements into its
    buffer (4 bytes for bf16 at the default): 4-byte but not 16-byte
    aligned, so that P1 takes its narrow variant on it."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _stats_library(x, w):
    """P2's library calls: ``torch.matmul``, then the two column sums of
    the product in f32 (three calls; no single call computes P2)."""
    yf = torch.matmul(x, w).float()
    return yf.sum(0), yf.square().sum(0)


def variants_ms(layer: str, stats: bool = False, rounds: int = 5,
                iters: int = 50) -> dict:
    """P1 (or P2 with ``stats``) at ``LAYERS[layer]`` on the card in
    alternating rounds (``alternating_ms``), on the same values: the
    stream, its narrow variant (fed x 4 bytes off 16-byte alignment) and
    the library call (``torch.matmul``; for P2 the matmul and the two
    column sums, and P1's stream beside them). Returns {"stream",
    "narrow", "library" (and "p1_stream"): [ms of each round]}; the narrow
    variant's launches are counted as any."""
    m, k, n, _ = LAYERS[layer]
    x, w = probe_inputs(m, k, n)
    moved = offset_copy(x)
    if (_mm_variant(x, w), _mm_variant(moved, w)) != ("stream", "narrow"):
        raise RuntimeError(f"the probe's inputs at {layer} miss its "
                           f"variants")
    fns = {"stream": lambda: probe_mm(x, w, stats),
           "narrow": lambda: probe_mm(moved, w, stats)}
    if stats:
        fns["p1_stream"] = lambda: probe_mm(x, w)
        fns["library"] = lambda: _stats_library(x, w)
    else:
        fns["library"] = lambda: torch.matmul(x, w)
    return alternating_ms(fns, rounds=rounds, iters=iters)


def main():
    name = torch.cuda.get_device_name(0)
    for stats in (False, True):
        for layer in LAYERS:
            times = variants_ms(layer, stats)
            print(f"{'P2' if stats else 'P1'} {layer} [{name}], medians of "
                  f"5 alternating rounds: "
                  + ", ".join(f"{key} {statistics.median(t):.4f} ms "
                              f"[{min(t):.4f}, {max(t):.4f}]"
                              for key, t in times.items()))
    for layer in LAYERS:
        for stats in (False, True):
            r = case(layer, stats)
            print(f"{'P2' if stats else 'P1'} {layer} {r['shape']} [{name}]: "
                  f"kernel {r['ms']:.4f} ms ({r['gbytes_per_s']:.1f} GB/s), "
                  f"plain {r['plain_ms']:.4f} ms, {r['library']} "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")


if __name__ == "__main__":
    main()
