"""Flash attention with SAM's decomposed relative-position bias.

Counterpart of ``simpleaicv_tpu/ops/flash_attention.py``'s
``flash_attention_relpos`` (the Pallas kernel ``_relpos_fwd_kernel`` and its
XLA twin ``flash_attention_relpos_xla``), forward only: serving needs no
backward.

``flash_attention_relpos`` dispatches on the tensors' device. CUDA tensors go
to the hand-written Hopper kernel in ``csrc/flash_relpos_fwd.cu``, which
never materialises the [N, N] bias; CPU tensors go to
``flash_attention_relpos_reference``, the plain version that materialises
bias and softmax. A CUDA tensor never takes the plain version: a kernel that
cannot build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["flash_attention_relpos", "flash_attention_relpos_reference",
           "KERNEL_LAUNCHES"]

# Launches of each hand kernel since the caller last set the count to 0; the
# wrapper adds one where it launches, and nowhere else.
KERNEL_LAUNCHES = {"flash_attention_relpos_fwd": 0}


def flash_attention_relpos_reference(q, k, v, rel_h, rel_w):
    """Plain version: q/k/v [BH, N, d], rel_h [BH, N, k_h], rel_w
    [BH, N, k_w] with N = k_h * k_w. Returns (o in q's dtype, lse f32 [BH, N])
    computed in f32 with the bias and softmax materialised."""
    bh, n, d = q.shape
    k_h, k_w = rel_h.shape[-1], rel_w.shape[-1]
    if k_h * k_w != n:
        raise ValueError(f"k_h*k_w={k_h}*{k_w} != N={n}")
    s = torch.einsum("bnd,bmd->bnm", q.float() * d**-0.5, k.float())
    s = (s.view(bh, n, k_h, k_w) + rel_h.float()[..., :, None]
         + rel_w.float()[..., None, :]).view(bh, n, n)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bnm,bmd->bnd", p, v.float()).to(q.dtype)
    return o, lse


def _check(q, k, v, rel_h, rel_w):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [BH, N, d] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    bh, n, d = q.shape
    if (rel_h.dim() != 3 or rel_w.dim() != 3 or rel_h.shape[:2] != (bh, n)
            or rel_w.shape[:2] != (bh, n)):
        raise ValueError(f"rel_h/rel_w must be [BH, N, k], got "
                         f"{tuple(rel_h.shape)} {tuple(rel_w.shape)}")
    if rel_h.shape[-1] * rel_w.shape[-1] != n:
        raise ValueError(f"k_h*k_w={rel_h.shape[-1]}*{rel_w.shape[-1]} != "
                         f"N={n}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("flash_relpos_fwd").flash_relpos_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_relpos_fwd_cuda(q, k, v, rel_h, rel_w):
    bh, n, d = q.shape
    k_h, k_w = rel_h.shape[-1], rel_w.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32 q/k/v, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if rel_h.dtype != torch.float32 or rel_w.dtype != torch.float32:
        raise TypeError("rel_h and rel_w must be float32")
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_h", rel_h),
                    ("rel_w", rel_w)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_w > 64 or d > 128 or d % 2:
        raise ValueError(f"kernel takes k_w <= 64 and even d <= 128, got "
                         f"k_w={k_w} d={d}")
    fn = _kernel()
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
                 rel_w.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, d,
                 k_h, k_w, int(q.dtype == torch.bfloat16), d**-0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_relpos_fwd launch failed: CUDA error {err}")
    KERNEL_LAUNCHES["flash_attention_relpos_fwd"] += 1
    return o, lse


def flash_attention_relpos(q, k, v, rel_h, rel_w):
    """Attention with SAM's decomposed rel-pos bias.

    q/k/v: [BH, N, d] (bf16 or f32) with N = k_h * k_w over a key grid;
    rel_h [BH, N, k_h] and rel_w [BH, N, k_w] f32;
    bias[q, kh * k_w + kw] = rel_h[q, kh] + rel_w[q, kw]; the d^-0.5 scale
    applies to q.k only. Returns (o [BH, N, d] in q's dtype, lse [BH, N] f32).
    CUDA tensors run the hand kernel, CPU tensors the plain version.
    """
    _check(q, k, v, rel_h, rel_w)
    if q.device.type == "cpu":
        return flash_attention_relpos_reference(q, k, v, rel_h, rel_w)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _flash_relpos_fwd_cuda(q, k, v, rel_h, rel_w)
