"""Flash attention: plain (ViT) and with SAM's decomposed relative-position
bias.

Counterpart of ``simpleaicv_tpu/ops/flash_attention.py``:

* ``flash_attention(q, k, v)`` on ``[B, H, N, d]``, differentiable, any N:
  the counterpart of both ``flash_attention`` (the Pallas kernels
  ``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``) and
  ``flash_attention_xla`` (what ViT calls). A ``torch.autograd.Function``
  saves ``(q, k, v, o, lse)``; its backward is FlashAttention-2's.
* ``attention_recompute(q, k, v)``: ``attention_recompute_xla``, a one-shot
  softmax forward with the same recompute backward. Plain tensor code in the
  JAX package, so plain PyTorch here on every device.
* ``flash_attention_relpos``: ``flash_attention_relpos`` (the Pallas kernels
  ``_relpos_fwd_kernel``, ``_relpos_dq_kernel``, ``_relpos_dkv_kernel``) and
  its XLA twin ``flash_attention_relpos_xla`` (what SAM calls),
  differentiable in all five tensor arguments. A ``torch.autograd.Function``
  saves ``(q, k, v, rel_h, rel_w, o, lse)``.

Every wrapper dispatches on the tensors' device. CUDA tensors go to the
hand-written Hopper kernels in ``csrc/``, which never materialise the
[N, N] scores; CPU tensors go to the plain versions
(``flash_attention_reference``, ``flash_attention_dq_reference``,
``flash_attention_dkv_reference``, ``flash_attention_relpos_reference``,
``flash_attention_relpos_dq_reference``,
``flash_attention_relpos_dkv_reference``), which do. A CUDA tensor never
takes a plain version: a kernel that cannot build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_backward_reference",
           "flash_attention_dq_reference", "flash_attention_dkv_reference",
           "attention_recompute",
           "flash_attention_relpos", "flash_attention_relpos_reference",
           "flash_attention_relpos_dq_reference",
           "flash_attention_relpos_dkv_reference", "KERNEL_LAUNCHES",
           "NARROW_LAUNCHES"]

# Launches of each hand kernel since the caller last set the count to 0; the
# wrapper adds one where it launches, and nowhere else.
KERNEL_LAUNCHES = {"flash_attention_relpos_fwd": 0,
                   "flash_attention_relpos_dq": 0,
                   "flash_attention_relpos_dkv": 0, "flash_attention_fwd": 0,
                   "flash_attention_dq": 0, "flash_attention_dkv": 0}
# Those of the launches above that took a kernel's narrow variant (bf16 rows
# not 16-byte aligned, or a shape the wide kernels do not serve), so that a
# run can show that its main path took the wide kernels.
NARROW_LAUNCHES = {"flash_attention_relpos_fwd": 0,
                   "flash_attention_relpos_dq": 0,
                   "flash_attention_relpos_dkv": 0, "flash_attention_fwd": 0,
                   "flash_attention_dq": 0, "flash_attention_dkv": 0}


# ------------------------- plain flash attention -------------------------

def flash_attention_reference(q, k, v, normalize_before_cast: bool = False):
    """Plain forward on [..., N, d]: returns (o in q's dtype, lse f32
    [..., N]), scores and softmax materialised in f32. The probabilities are
    rounded to v's dtype before p.v: unnormalised and divided by the row sum
    after the product, as the online-softmax kernels must, or normalised
    first (``normalize_before_cast``, the one-shot softmax of
    ``attention_recompute``)."""
    d = q.shape[-1]
    s = torch.einsum("...nd,...md->...nm", q.float() * d**-0.5, k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if normalize_before_cast:
        o = torch.einsum("...nm,...md->...nd", (p / l).to(v.dtype).float(),
                         v.float())
    else:
        o = torch.einsum("...nm,...md->...nd", p.to(v.dtype).float(),
                         v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _recompute(q, k, v, do, lse, delta):
    """(p, ds) of the backward, both f32 [..., N, N]: p = exp(s - lse) from
    the saved row logsumexp and ds = p * (dO v^T - delta)."""
    s = torch.einsum("...nd,...md->...nm", q.float() * q.shape[-1]**-0.5,
                     k.float())
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("...nd,...md->...nm", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_dq_reference(q, k, v, do, lse, delta):
    """Plain dq = d^-0.5 * ds k, with ds rounded to q's dtype first."""
    _, ds = _recompute(q, k, v, do, lse, delta)
    dq = torch.einsum("...nm,...md->...nd", ds.to(q.dtype).float(), k.float())
    return (dq * q.shape[-1]**-0.5).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta):
    """Plain (dk, dv): dv = p^T dO with p rounded to dO's dtype, and
    dk = d^-0.5 * ds^T q with ds rounded to q's dtype."""
    p, ds = _recompute(q, k, v, do, lse, delta)
    dv = torch.einsum("...nm,...nd->...md", p.to(do.dtype).float(),
                      do.float())
    dk = torch.einsum("...nm,...nd->...md", ds.to(q.dtype).float(), q.float())
    return (dk * q.shape[-1]**-0.5).to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, o, lse, do):
    """Plain FlashAttention-2 backward from the saved residuals: (dq, dk,
    dv), with the probabilities recomputed from ``lse`` and
    delta = rowsum(dO * o) in f32."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return (flash_attention_dq_reference(q, k, v, do, lse, delta),
            *flash_attention_dkv_reference(q, k, v, do, lse, delta))


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, N, d] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


_VIEW = [ctypes.c_void_p] + [ctypes.c_longlong] * 3
_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _flash_kernels():
    """{name: C function} of ``flash_fwd`` ("fwd", "fwd_narrow") and
    ``flash_bwd`` ("dq", "dq_narrow", "dkv", "dkv_narrow"), both libraries
    built together."""
    _build.build(["flash_fwd", "flash_bwd"])
    lib = _build.load("flash_fwd")
    bwd = _build.load("flash_bwd")
    kernels = {}
    # (name, strided views, then f32 row pointers: lse, or lse and delta)
    for name, views, rows in (("fwd", 4, 1), ("dq", 5, 2), ("dkv", 6, 2)):
        for key in (name, f"{name}_narrow"):
            fn = getattr(lib if name == "fwd" else bwd, f"flash_{key}")
            fn.argtypes = _VIEW * views + [ctypes.c_void_p] * rows + _TAIL
            fn.restype = ctypes.c_int
            kernels[key] = fn
    return kernels


def _vector_loads(*tensors) -> bool:
    """Whether the bf16 kernels may move ``tensors`` 16 bytes a thread (the
    forward kernels by 16-byte copies or TMA, the backward kernels by TMA):
    every row 16-byte aligned (the data pointer, and every stride but the
    last a multiple of 8 elements) and d a multiple of 8. Tensors that miss
    it take the kernels' narrow variants, with 4-byte copies."""
    return all(t.dtype == torch.bfloat16 and t.shape[-1] % 8 == 0
               and t.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s in t.stride()[:-1])
               for t in tensors)


def _readable(t):
    """``t`` as the kernels read it in place: unit stride over d and, for
    bf16's paired loads, 4-byte aligned rows; else a contiguous copy."""
    pairs = t.dtype == torch.bfloat16
    ok = t.shape[-1] == 1 or t.stride(-1) == 1
    if ok and pairs:
        ok = t.data_ptr() % 4 == 0 and all(s % 2 == 0 for s in t.stride()[:3])
    return t if ok else t.contiguous()


def _view(t):
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def _empty_bnhd(like):
    """An uninitialised [B, H, N, d] tensor stored as [B, N, H, d]: the
    layout of the fused qkv projection's slices and of the output
    projection's input, so neither side of the attention needs a copy."""
    b, h, n, d = like.shape
    return torch.empty((b, n, h, d), dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _kernel_tail(q):
    b, h, n, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32 q/k/v, got {q.dtype}")
    if d > 128 or (q.dtype == torch.bfloat16 and d % 2):
        raise ValueError(f"kernel takes d <= 128 (even for bf16), got d={d}")
    return [b, h, n, d, int(q.dtype == torch.bfloat16), d**-0.5,
            torch.cuda.current_stream(q.device).cuda_stream]


def _launch(name, fn, args, narrow=False):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1
    if narrow:
        NARROW_LAUNCHES[name] += 1


def _flash_fwd_cuda(q, k, v):
    q, k, v = _readable(q), _readable(k), _readable(v)
    o = _empty_bnhd(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    narrow = q.dtype == torch.bfloat16 and not _vector_loads(q, k, v, o)
    with torch.cuda.device(q.device):
        _launch("flash_attention_fwd",
                _flash_kernels()["fwd_narrow" if narrow else "fwd"],
                _view(q) + _view(k) + _view(v) + _view(o) + [lse.data_ptr()]
                + _kernel_tail(q), narrow)
    return o, lse


def _flash_bwd_variant(q, k, v, do) -> str:
    """Which backward kernels (K2, K3) take these inputs, as
    ``csrc/flash_bwd.cu`` documents: "tma" (the persistent wgmma kernels fed
    by TMA: bf16 with d <= 64 and every row 16-byte aligned, ViT-B/16's
    layers), "narrow" (the mma.sync kernels: other bf16 inputs, d 80 and
    128 among them) or "f32" (the FMA kernels). Launches nothing."""
    if q.dtype != torch.bfloat16:
        return "f32"
    if q.shape[-1] <= 64 and _vector_loads(q, k, v, do):
        return "tma"
    return "narrow"


def _bwd_args(q, k, v, do, lse, delta):
    """(the tensors as launched, the inputs' arguments, the closing
    arguments) of a backward kernel; the caller holds the tensors until the
    launch is enqueued."""
    q, k, v, do = _readable(q), _readable(k), _readable(v), _readable(do)
    lse, delta = lse.contiguous(), delta.contiguous()
    return ((q, k, v, do, lse, delta),
            _view(q) + _view(k) + _view(v) + _view(do),
            [lse.data_ptr(), delta.data_ptr()] + _kernel_tail(q))


def _flash_dq_cuda(q, k, v, do, lse, delta):
    held, inputs, tail = _bwd_args(q, k, v, do, lse, delta)
    narrow = _flash_bwd_variant(*held[:4]) == "narrow"
    dq = _empty_bnhd(q)
    with torch.cuda.device(q.device):
        _launch("flash_attention_dq",
                _flash_kernels()["dq_narrow" if narrow else "dq"],
                inputs + _view(dq) + tail, narrow)
    del held
    return dq


def _flash_dkv_cuda(q, k, v, do, lse, delta):
    held, inputs, tail = _bwd_args(q, k, v, do, lse, delta)
    narrow = _flash_bwd_variant(*held[:4]) == "narrow"
    dk, dv = _empty_bnhd(q), _empty_bnhd(q)
    with torch.cuda.device(q.device):
        _launch("flash_attention_dkv",
                _flash_kernels()["dkv_narrow" if narrow else "dkv"],
                inputs + _view(dk) + _view(dv) + tail, narrow)
    del held
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do):
    do = _readable(do.to(q.dtype))
    # delta = rowsum(dO * o) in f32 is outside the TPU kernels too
    delta = (do.float() * o.float()).sum(dim=-1)
    return (_flash_dq_cuda(q, k, v, do, lse, delta),
            *_flash_dkv_cuda(q, k, v, do, lse, delta))


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse); CPU tensors take the plain versions, CUDA
    tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v)
        else:
            o, lse = _flash_fwd_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_backward_reference(q, k, v, o, lse, do)
        return _flash_bwd_cuda(q, k, v, o, lse, do)


def flash_attention(q, k, v):
    """softmax(d^-0.5 q k^T) v on [B, H, N, d] (bf16 or f32), any N.
    Differentiable: the backward recomputes the probabilities from the saved
    row logsumexp (FlashAttention-2). CUDA tensors run the hand kernels,
    which read strided inputs in place and return ``o`` as a [B, H, N, d]
    view of [B, N, H, d] storage; CPU tensors run the plain versions."""
    _check_qkv(q, k, v)
    return _FlashAttention.apply(q, k, v)


class _AttentionRecompute(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_reference(q, k, v,
                                           normalize_before_cast=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_backward_reference(*ctx.saved_tensors, do)


def attention_recompute(q, k, v):
    """Exact softmax attention on [B, H, N, d] with a one-shot softmax
    forward that saves only (q, k, v, o, lse) and the recompute backward of
    ``flash_attention``: no [B, H, N, N] residual is kept. Plain tensor code
    on every device, as in the JAX package."""
    _check_qkv(q, k, v)
    return _AttentionRecompute.apply(q, k, v)


# ---------------- decomposed-rel-pos flash attention (SAM) ----------------

def _relpos_scores(q, k, rel_h, rel_w):
    """f32 [BH, N, N] scores d^-0.5 q k^T + rel_h[q, kh] + rel_w[q, kw]."""
    bh, n, d = q.shape
    k_h, k_w = rel_h.shape[-1], rel_w.shape[-1]
    if k_h * k_w != n:
        raise ValueError(f"k_h*k_w={k_h}*{k_w} != N={n}")
    s = torch.einsum("bnd,bmd->bnm", q.float() * d**-0.5, k.float())
    return (s.view(bh, n, k_h, k_w) + rel_h.float()[..., :, None]
            + rel_w.float()[..., None, :]).view(bh, n, n)


def flash_attention_relpos_reference(q, k, v, rel_h, rel_w):
    """Plain version: q/k/v [BH, N, d], rel_h [BH, N, k_h], rel_w
    [BH, N, k_w] with N = k_h * k_w. Returns (o in q's dtype, lse f32 [BH, N])
    with the bias and softmax materialised in f32. The unnormalised
    probabilities are rounded to v's dtype before p.v and the product is
    divided by the row sum after, as the online-softmax kernel and the JAX
    package's XLA twin do."""
    s = _relpos_scores(q, k, rel_h, rel_w)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnm,bmd->bnd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _relpos_recompute(q, k, v, rel_h, rel_w, do, lse, delta):
    """(p, ds) of the rel-pos backward, both f32 [BH, N, N]."""
    p = torch.exp(_relpos_scores(q, k, rel_h, rel_w) - lse[..., None])
    dp = torch.einsum("bnd,bmd->bnm", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_relpos_dq_reference(q, k, v, rel_h, rel_w, do, lse,
                                        delta):
    """Plain (dq, drh, drw): dq = d^-0.5 * ds k with ds rounded to q's dtype
    first; drh[q, kh] and drw[q, kw] are the sums of the unrounded f32 ds
    over the other key axis, in rel_h's and rel_w's dtype."""
    _, ds = _relpos_recompute(q, k, v, rel_h, rel_w, do, lse, delta)
    dq = torch.einsum("bnm,bmd->bnd", ds.to(q.dtype).float(), k.float())
    ds4 = ds.view(*ds.shape[:2], rel_h.shape[-1], rel_w.shape[-1])
    return ((dq * q.shape[-1]**-0.5).to(q.dtype),
            ds4.sum(dim=-1).to(rel_h.dtype), ds4.sum(dim=-2).to(rel_w.dtype))


def flash_attention_relpos_dkv_reference(q, k, v, rel_h, rel_w, do, lse,
                                         delta):
    """Plain (dk, dv): dv = p^T dO with p rounded to dO's dtype, and
    dk = d^-0.5 * ds^T q with ds rounded to q's dtype."""
    p, ds = _relpos_recompute(q, k, v, rel_h, rel_w, do, lse, delta)
    dv = torch.einsum("bnm,bnd->bmd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bnm,bnd->bmd", ds.to(q.dtype).float(), q.float())
    return (dk * q.shape[-1]**-0.5).to(k.dtype), dv.to(v.dtype)


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


_RELPOS_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _relpos_fwd_kernels():
    """(flash_relpos_fwd, flash_relpos_fwd_narrow)."""
    lib = _build.load("flash_relpos_fwd")
    for fn in (lib.flash_relpos_fwd, lib.flash_relpos_fwd_narrow):
        fn.argtypes = [ctypes.c_void_p] * 7 + _RELPOS_TAIL
        fn.restype = ctypes.c_int
    return lib.flash_relpos_fwd, lib.flash_relpos_fwd_narrow


@functools.lru_cache(maxsize=None)
def _relpos_bwd_kernels():
    """{(side, narrow): C function}: ``flash_relpos_dq`` and
    ``flash_relpos_dkv`` (sides "dq" and "dkv") and their ``_narrow``
    variants."""
    lib = _build.load("flash_relpos_bwd")
    kernels = {}
    for side, pointers in (("dq", 11), ("dkv", 10)):
        for narrow in (False, True):
            fn = getattr(lib, f"flash_relpos_{side}"
                         + ("_narrow" if narrow else ""))
            fn.argtypes = [ctypes.c_void_p] * pointers + _RELPOS_TAIL
            fn.restype = ctypes.c_int
            kernels[side, narrow] = fn
    return kernels


def _relpos_bwd_variant(q, k, v, do, rel_w) -> str:
    """Which rel-pos backward kernels (K5, K6) take these inputs, as
    ``csrc/flash_relpos_bwd.cu`` documents: "tma" (the wgmma kernels fed by
    TMA: bf16 with k_w 64, d <= 64 and every row 16-byte aligned, SAM's
    global layers), "narrow" (the mma.sync kernels: other bf16 inputs) or
    "f32" (the FMA kernels). Launches nothing."""
    if q.dtype != torch.bfloat16:
        return "f32"
    if (rel_w.shape[-1] == 64 and q.shape[-1] <= 64
            and _vector_loads(q, k, v, do)):
        return "tma"
    return "narrow"


def _relpos_kernel_args(inputs, outputs):
    """The arguments of a rel-pos kernel: the pointers of ``inputs`` (q, k,
    v, [dO,] rel_h, rel_w, [lse, delta]) and ``outputs``, then the shape,
    the dtype flag, the scale and the stream. Raises on what the kernels do
    not take; every tensor must be contiguous and on q's device."""
    q, rel_h, rel_w = inputs["q"], inputs["rel_h"], inputs["rel_w"]
    bh, n, d = q.shape
    k_h, k_w = rel_h.shape[-1], rel_w.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bf16 or f32 q/k/v, got {q.dtype}")
    for name, t in inputs.items():
        want = q.dtype if name in ("q", "k", "v", "do") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_w > 64 or d > 128 or d % 2:
        raise ValueError(f"kernel takes k_w <= 64 and even d <= 128, got "
                         f"k_w={k_w} d={d}")
    return ([t.data_ptr() for t in (*inputs.values(), *outputs)]
            + [bh, n, d, k_h, k_w, int(q.dtype == torch.bfloat16), d**-0.5,
               torch.cuda.current_stream(q.device).cuda_stream])


def _flash_relpos_fwd_cuda(q, k, v, rel_h, rel_w):
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    args = _relpos_kernel_args(
        dict(q=q, k=k, v=v, rel_h=rel_h, rel_w=rel_w), (o, lse))
    fwd, fwd_narrow = _relpos_fwd_kernels()
    narrow = q.dtype == torch.bfloat16 and not _vector_loads(q, k, v)
    with torch.cuda.device(q.device):
        _launch("flash_attention_relpos_fwd", fwd_narrow if narrow else fwd,
                args, narrow)
    return o, lse


def _flash_relpos_dq_cuda(q, k, v, rel_h, rel_w, do, lse, delta):
    dq = torch.empty_like(q)
    drh, drw = torch.empty_like(rel_h), torch.empty_like(rel_w)
    args = _relpos_kernel_args(
        dict(q=q, k=k, v=v, do=do, rel_h=rel_h, rel_w=rel_w, lse=lse,
             delta=delta), (dq, drh, drw))
    narrow = _relpos_bwd_variant(q, k, v, do, rel_w) == "narrow"
    with torch.cuda.device(q.device):
        _launch("flash_attention_relpos_dq",
                _relpos_bwd_kernels()["dq", narrow], args, narrow)
    return dq, drh, drw


def _flash_relpos_dkv_cuda(q, k, v, rel_h, rel_w, do, lse, delta):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    args = _relpos_kernel_args(
        dict(q=q, k=k, v=v, do=do, rel_h=rel_h, rel_w=rel_w, lse=lse,
             delta=delta), (dk, dv))
    narrow = _relpos_bwd_variant(q, k, v, do, rel_w) == "narrow"
    with torch.cuda.device(q.device):
        _launch("flash_attention_relpos_dkv",
                _relpos_bwd_kernels()["dkv", narrow], args, narrow)
    return dk, dv


class _FlashAttentionRelpos(torch.autograd.Function):
    """Saves (q, k, v, rel_h, rel_w, o, lse) and nothing else between the
    forward and the backward, so a checkpointed layer may run the forward
    twice. CPU tensors take the plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w):
        if q.device.type == "cpu":
            o, lse = flash_attention_relpos_reference(q, k, v, rel_h, rel_w)
        else:
            o, lse = _flash_relpos_fwd_cuda(q, k, v, rel_h, rel_w)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, rel_h, rel_w, o, lse = ctx.saved_tensors
        # the kernels take contiguous tensors; autograd hands dO over
        # contiguous already where it comes from SAM's head merge
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * o) in f32 is outside the TPU kernels too
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (q, k, v, rel_h, rel_w, do, lse, delta)
        if q.device.type == "cpu":
            dq, drh, drw = flash_attention_relpos_dq_reference(*args)
            dk, dv = flash_attention_relpos_dkv_reference(*args)
        else:
            dq, drh, drw = _flash_relpos_dq_cuda(*args)
            dk, dv = _flash_relpos_dkv_cuda(*args)
        return dq, dk, dv, drh, drw


def flash_attention_relpos(q, k, v, rel_h, rel_w):
    """Attention with SAM's decomposed rel-pos bias.

    q/k/v: [BH, N, d] (bf16 or f32) with N = k_h * k_w over a key grid;
    rel_h [BH, N, k_h] and rel_w [BH, N, k_w] f32;
    bias[q, kh * k_w + kw] = rel_h[q, kh] + rel_w[q, kw]; the d^-0.5 scale
    applies to q.k only. Returns (o [BH, N, d] in q's dtype, lse [BH, N] f32).
    ``o`` is differentiable in all five arguments (the backward recomputes
    the probabilities from the saved ``lse``); ``lse`` carries no gradient.
    CUDA tensors run the hand kernels, forward and backward, and must be
    contiguous; CPU tensors run the plain versions.
    """
    _check(q, k, v, rel_h, rel_w)
    return _FlashAttentionRelpos.apply(q, k, v, rel_h, rel_w)
