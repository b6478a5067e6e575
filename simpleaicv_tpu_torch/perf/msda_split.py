"""Where does the MSDA backward's time go at DINO-DETR's encoder launch?

    python -m simpleaicv_tpu_torch.perf.msda_split   # on the card

Builds the two backward kernels of ``ops/csrc/msda.cu`` in variants that
change one statement each, and times them on the same inputs in alternating
rounds (medians of 5 rounds of 10 launches, the kernels alone: grad_value is
not zeroed between launches).

The narrow kernel (``msda_bwd_narrow``: one warp per (batch, query, head),
lane = channel, four scalar atomic adds into grad_value per sample and lane):

* ``narrow``: as it stands;
* ``narrow_private_rows``: each warp adds into a scratch row of its own, so
  that no two warps add into one address: the same instructions, no
  contention;
* ``narrow_private_corner_rows``: a scratch row per warp and corner, so that
  the four adds of a sample go to four addresses as in ``narrow``;
* ``narrow_no_adds``: the add removed: the gathers and the reductions alone.

The tiled kernel (``msda_bwd_tiled``, the one the package launches here):

* ``tiled``: as it stands;
* ``tiled_no_adds``: its vector adds into grad_value removed;
* ``tiled_no_gathers``: its 16-byte value gathers replaced by values made
  from the row index, so the adds and the reductions run alone.

A variant without adds is the gathers' and reductions' time, the difference
to the kernel the adds' share; ``narrow - narrow_private_*`` is the cost of
contention. The variants' sources are written into the git-ignored build
directory; nothing in the package uses them.

``launch_inputs`` makes the inputs of a DINO-DETR MSDA launch at batch 2,
also for ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from ..models.detection import dinodetr
from ..ops import _build, msda
from .timing import alternating_ms

__all__ = ["DINO_BATCH", "DINO_LEVELS", "DINO_HEADS", "DINO_HEAD_DIM",
           "DINO_POINTS", "launch_inputs", "main"]

DINO_BATCH = 2
DINO_LEVELS = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))
DINO_HEADS, DINO_HEAD_DIM, DINO_POINTS = 8, 32, 4

# the statements the variants change, and what each puts there:
# (kernel's C entry, statement, replacement)
NARROW_ADD = "atomicAdd(gvb + cr.off[k] + d, a * cw[k] * g[c]);"
TILED_ADD = """          atomicAdd(reinterpret_cast<float4*>(
                        gvb + static_cast<long long>(row) * row_stride +
                        4 * cc),
                    make_float4(fr * ga.x, fr * ga.y, fr * ga.z, fr * ga.w));"""
TILED_GATHER = "tp.v[t] = inside && c < D ? ldg4(vr + c)"
VARIANTS = {
    "narrow": ("msda_backward_narrow", NARROW_ADD, NARROW_ADD),
    "narrow_private_rows": (
        "msda_backward_narrow", NARROW_ADD,
        "atomicAdd(grad_value + warp * D + d, a * cw[k] * g[c]);"),
    "narrow_private_corner_rows": (
        "msda_backward_narrow", NARROW_ADD,
        "atomicAdd(grad_value + (warp * 4 + k) * D + d, a * cw[k] * g[c]);"),
    "narrow_no_adds": ("msda_backward_narrow", NARROW_ADD, ""),
    "tiled": ("msda_backward", TILED_ADD, TILED_ADD),
    "tiled_no_adds": ("msda_backward", TILED_ADD, "          {}"),
    "tiled_no_gathers": (
        "msda_backward", TILED_GATHER,
        "tp.v[t] = inside && c < D ? make_float4(tp.row, c, 1.f, 0.5f)"),
}


def launch_inputs(lq, seed, boxes):
    """The MSDA kernels' inputs at a DINO-DETR launch at batch 2, on the
    card: value [2, S, 8, 32]; locations as the model forms them at its
    initial offsets (the directional bias, up to 4 cells, plus noise):
    around every cell centre of every level (the encoder, ``boxes`` False,
    ``lq`` = S) or around ``lq`` random boxes (the decoder's 4-D form);
    softmax weights; grad_out [2, lq, 256]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, d, p = DINO_BATCH, DINO_HEADS, DINO_HEAD_DIM, DINO_POINTS
    n_levels = len(DINO_LEVELS)
    s = sum(hh * ww for hh, ww in DINO_LEVELS)
    value = torch.randn(b, s, h, d, generator=g, device="cuda")
    offsets = (dinodetr._offsets_bias(h, n_levels, p).cuda().reshape(
        h, n_levels, p, 2) + 0.5 * torch.randn(
        b, lq, h, n_levels, p, 2, generator=g, device="cuda"))
    if boxes:
        ref = torch.rand(b, lq, 1, 1, 1, 4, generator=g, device="cuda")
        ref_wh = 0.05 + 0.3 * ref[..., 2:]
        loc = ref[..., :2] + offsets / p * ref_wh * 0.5
    else:
        centres = torch.cat([dinodetr._grid_centres(hh, ww, "cuda")
                             for hh, ww in DINO_LEVELS])
        wh = torch.tensor([[ww, hh] for hh, ww in DINO_LEVELS],
                          dtype=torch.float32, device="cuda")
        loc = (centres[None, :, None, None, None, :]
               + offsets / wh[None, None, None, :, None, :])
    wts = torch.softmax(torch.randn(b, lq, h, n_levels * p, generator=g,
                                    device="cuda"), -1).reshape(
        b, lq, h, n_levels, p)
    grad_out = torch.randn(b, lq, h * d, generator=g, device="cuda")
    return value, loc.contiguous(), wts, grad_out


def _build_variants():
    """{variant: its backward's C function}, built in parallel."""
    src = (_build.CSRC_DIR / "msda.cu").read_text()
    out_dir = _build.BUILD_DIR / "msda_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (entry, old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"msda.cu no longer has the statement the "
                               f"{name} variant changes")
        cu = out_dir / f"msda_{name}.cu"
        cu.write_text(src.replace(old, new))
        lib = out_dir / f"libmsda_{name}.so"
        procs[name] = (entry, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (entry, lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(iters: int = 10, rounds: int = 5):
    card = torch.cuda.get_device_name(0)
    shapes = DINO_LEVELS
    lq = sum(hh * ww for hh, ww in shapes)
    value, loc, wts, grad_out = launch_inputs(lq, 70, boxes=False)
    if msda._msda_bwd_variant(value, shapes, loc) != "tiled":
        raise RuntimeError("the encoder launch does not take the tiled "
                           "kernel")
    b, s, h, d = value.shape
    n_levels, p = loc.shape[3], loc.shape[4]
    fns = _build_variants()
    table = (ctypes.c_int * (2 * n_levels))(*[x for hw in shapes for x in hw])
    stream = torch.cuda.current_stream().cuda_stream
    grad_loc, grad_wts = torch.empty_like(loc), torch.empty_like(wts)
    warps = b * lq * h
    # large enough for every variant's rows: grad_value, or 4 per warp
    scratch = torch.zeros(max(b * s * h * d, warps * 4 * d),
                          device="cuda")

    def run(fn):
        err = fn(value.data_ptr(), loc.data_ptr(), wts.data_ptr(),
                 grad_out.data_ptr(), scratch.data_ptr(), grad_loc.data_ptr(),
                 grad_wts.data_ptr(), b, s, h, d, lq, n_levels, p, table,
                 stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    times = alternating_ms({name: (lambda fn=fn: run(fn))
                            for name, fn in fns.items()},
                           rounds=rounds, iters=iters)
    print(f"MSDA backward at DINO-DETR's encoder launch (value [{b}, {s}, "
          f"{h}, {d}], Lq {lq}, {n_levels} levels, {p} points), medians of "
          f"{rounds} alternating rounds of {iters} launches [{card}]:")
    med = {name: statistics.median(t) for name, t in times.items()}
    for name, t in times.items():
        print(f"  {name:28s} {med[name]:.4f} ms  rounds "
              + " ".join(f"{x:.4f}" for x in t))
    private = min(med["narrow_private_rows"],
                  med["narrow_private_corner_rows"])
    print(f"  narrow: gathers and reductions {med['narrow_no_adds']:.4f} ms, "
          f"atomic instructions {private - med['narrow_no_adds']:.4f} ms, "
          f"contention {med['narrow'] - private:.4f} ms")
    print(f"  tiled: without its adds {med['tiled_no_adds']:.4f} ms, "
          f"without its gathers {med['tiled_no_gathers']:.4f} ms, the adds' "
          f"share {med['tiled'] - med['tiled_no_adds']:.4f} ms; "
          f"{med['narrow'] / med['tiled']:.3f} times faster than the narrow "
          f"kernel")
    return med


if __name__ == "__main__":
    main()
