"""How close does a hand elementwise kernel come to the card's memory rate?
Counterpart of ``perf/pallas_bw_probe.py``:

    python -m simpleaicv_tpu_torch.perf.bw_probe   # on the card

``probe_scale(x)`` is P3, the hand kernel of ``ops/csrc/probes.cu``:
o = x * bf16(1.0001) over a bf16 tensor. bf16(1.0001) is 1.0, so o equals
x, but the kernel reads and writes every byte. CUDA tensors launch the
kernel; CPU tensors take the plain version ``scale_plain``. ``case`` times
it at ResNet-50's layer-1 activation, [401408, 256] bf16.
"""

from __future__ import annotations

import torch

from .matmul_probe import _lib
from .timing import bound, cuda_ms

__all__ = ["probe_scale", "scale_plain", "case", "SHAPE", "KERNEL_LAUNCHES"]

KERNEL_LAUNCHES = {"probe_scale": 0}

SHAPE = (128 * 56 * 56, 256)  # the layer-1 activation [B*H*W, C]
SCALE = 1.0001


def scale_plain(x):
    """P3's plain version: each value times bf16(1.0001) in f32, rounded to
    bf16."""
    s = float(torch.tensor(SCALE, dtype=torch.bfloat16))
    return (x.float() * s).to(torch.bfloat16)


def probe_scale(x):
    """x * bf16(1.0001) for a bf16 tensor: CUDA tensors run P3 (contiguous,
    16-byte aligned, any size), CPU tensors the plain version."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the probe is bf16, got {x.dtype}")
    if x.device.type == "cpu":
        return scale_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if x.numel() == 0:
        raise ValueError("x is empty")
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().probe_scale(
            x.data_ptr(), o.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_scale launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["probe_scale"] += 1
    return o


def case(iters: int = 50) -> dict:
    """Times P3 at ``SHAPE`` on the card beside its plain version, the
    library call ``x * torch.tensor(1.0001, dtype=torch.bfloat16)`` and its
    bound. Times in ms."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    s = torch.tensor(SCALE, dtype=torch.bfloat16, device="cuda")
    ms = cuda_ms(lambda: probe_scale(x), iters)
    nbytes = 2 * x.numel() * 2
    out = {"shape": f"{SHAPE[0]}x{SHAPE[1]} bf16", "ms": ms,
           "plain_ms": cuda_ms(lambda: scale_plain(x), iters),
           "library_ms": cuda_ms(lambda: x * s, iters),
           "library": "x * torch.tensor(1.0001, dtype=torch.bfloat16)",
           "bytes": nbytes, "gbytes_per_s": nbytes / ms / 1e6}
    out["bound_ms"], out["bound_by"] = bound(float(x.numel()), nbytes,
                                             torch.bfloat16)
    return out


def main():
    r = case()
    print(f"P3 {r['shape']} [{torch.cuda.get_device_name(0)}]: kernel "
          f"{r['ms']:.4f} ms ({r['gbytes_per_s']:.1f} GB/s), plain "
          f"{r['plain_ms']:.4f} ms, {r['library']} {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


if __name__ == "__main__":
    main()
