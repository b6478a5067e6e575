"""Multi-scale deformable attention (counterpart of
``simpleaicv_tpu/ops/msda.py`` and ``simpleaicv_tpu/ops/msda_pallas.py``).

``ms_deform_attn(value, spatial_shapes, sampling_locations,
attention_weights)`` has the JAX package's contract:

* ``value`` [B, S, H, D] with S the sum of h * w over the levels;
* ``spatial_shapes`` a static tuple ((h0, w0), (h1, w1), ...);
* ``sampling_locations`` [B, Lq, H, L, P, 2] as (x, y) in [0, 1];
* ``attention_weights`` [B, Lq, H, L, P];
* the result [B, Lq, H * D] in f32.

Bilinear samples with align_corners=False and zero padding outside each
level, weighted and summed in f32; the inputs are cast to f32 first, as
``ms_deform_attn_xla`` casts them. The one function stands for both the
JAX package's XLA core and its Pallas kernel, and is differentiable in the
value, the locations and the weights (a ``torch.autograd.Function`` that
saves its three inputs).

It dispatches on the tensors' device. CUDA tensors launch the hand kernels
of ``csrc/msda.cu``: ``msda_fwd`` (K7, the Pallas kernel's counterpart: a
tiled kernel, or its narrow variant for what that does not take,
``_msda_fwd_variant``) and ``msda_bwd``
(its backward, which the JAX package left to autodiff: a tiled kernel, or
its narrow variant for what that does not take, ``_msda_bwd_variant``).
``NARROW_LAUNCHES`` counts the narrow variants' launches. CPU
tensors take the plain versions: ``ms_deform_attn_reference``, a
transcription of ``_bilinear_gather_level`` and ``ms_deform_attn_xla``, and
its autograd (``ms_deform_attn_backward_reference``). A CUDA tensor never
takes a plain version: a kernel that cannot build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["ms_deform_attn", "ms_deform_attn_reference",
           "ms_deform_attn_backward_reference", "KERNEL_LAUNCHES",
           "NARROW_LAUNCHES"]

# Launches of each hand kernel since the caller last set the count to 0; the
# wrapper adds one where it launches, and nowhere else.
KERNEL_LAUNCHES = {"msda_fwd": 0, "msda_bwd": 0}
# Those of the launches above that took a kernel's narrow variant (a shape
# or a layout the tiled kernel does not serve), so that a run can show that
# its main path took the tiled kernel.
NARROW_LAUNCHES = {"msda_fwd": 0, "msda_bwd": 0}

MAX_LEVELS = 8
MAX_HEAD_DIM = 64


def _bilinear_gather_level(value_l, loc, h: int, w: int):
    """value_l [B, h*w, H, D]; loc [B, Lq, H, P, 2] in [0, 1]. Returns the
    samples [B, Lq, H, P, D], zero outside the level."""
    b, _, heads, d = value_l.shape
    lq, p = loc.shape[1], loc.shape[3]
    # align_corners=False: x_pix = x * W - 0.5
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    v = value_l.permute(0, 2, 1, 3)                      # [B, H, S, D]

    def gather(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        xi = torch.clamp(xx, 0, w - 1).long()
        yi = torch.clamp(yy, 0, h - 1).long()
        idx = (yi * w + xi).permute(0, 2, 1, 3).reshape(b, heads, lq * p)
        out = torch.gather(v, 2, idx[..., None].expand(-1, -1, -1, d))
        out = out.reshape(b, heads, lq, p, d).permute(0, 2, 1, 3, 4)
        return out * inside[..., None].to(out.dtype)

    v00, v01 = gather(y0, x0), gather(y0, x0 + 1)
    v10, v11 = gather(y0 + 1, x0), gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def ms_deform_attn_reference(value, spatial_shapes, sampling_locations,
                             attention_weights):
    """The plain version: ``ms_deform_attn_xla`` in PyTorch. Materialises
    four [B, Lq, H, P, D] f32 corner gathers per level. Differentiable by
    autograd, whose gradients are the reference ones."""
    b, _, heads, d = value.shape
    lq = sampling_locations.shape[1]
    out = torch.zeros((b, lq, heads, d), dtype=torch.float32,
                      device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        h, w = int(h), int(w)
        sampled = _bilinear_gather_level(
            value[:, start:start + h * w].float(),
            sampling_locations[:, :, :, lid].float(), h, w)
        wts = attention_weights[:, :, :, lid].float()
        out = out + (sampled * wts[..., None]).sum(dim=3)
        start += h * w
    return out.reshape(b, lq, heads * d)


def ms_deform_attn_backward_reference(value, spatial_shapes,
                                      sampling_locations, attention_weights,
                                      grad_out):
    """The plain backward: (grad_value, grad_locations, grad_weights) of
    ``ms_deform_attn_reference`` by autograd, each in f32."""
    with torch.enable_grad():
        inputs = [t.detach().float().requires_grad_()
                  for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_reference(inputs[0], spatial_shapes, *inputs[1:])
        return torch.autograd.grad(out, inputs, grad_out.float())


def _check(value, spatial_shapes, sampling_locations, attention_weights):
    if value.dim() != 4:
        raise ValueError(f"value must be [B, S, H, D], got "
                         f"{tuple(value.shape)}")
    b, s, heads, _ = value.shape
    n_levels = len(spatial_shapes)
    if sum(int(h) * int(w) for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not cover the "
                         f"value's {s} rows")
    loc, wts = sampling_locations, attention_weights
    if (loc.dim() != 6 or loc.shape[0] != b or loc.shape[2] != heads
            or loc.shape[3] != n_levels or loc.shape[5] != 2):
        raise ValueError(f"sampling_locations must be [B, Lq, H, L, P, 2], "
                         f"got {tuple(loc.shape)}")
    if tuple(wts.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be [B, Lq, H, L, P] = "
                         f"{tuple(loc.shape[:5])}, got {tuple(wts.shape)}")
    for t in (loc, wts):
        if t.device != value.device:
            raise ValueError(f"inputs on {t.device} and {value.device}")
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {value.device}")


@functools.lru_cache(maxsize=None)
def _kernels():
    """{name: C function} of the library built from msda.cu: "fwd" (K7's
    tiled kernel), "fwd_narrow" (its narrow variant), "bwd" (K7b's tiled
    kernel) and "bwd_narrow" (its narrow variant)."""
    lib = _build.load("msda")
    tail = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    kernels = {"fwd": lib.msda_forward, "fwd_narrow": lib.msda_forward_narrow,
               "bwd": lib.msda_backward,
               "bwd_narrow": lib.msda_backward_narrow}
    for fn in (kernels["fwd"], kernels["fwd_narrow"]):
        fn.argtypes = [ctypes.c_void_p] * 4 + tail
    for fn in (kernels["bwd"], kernels["bwd_narrow"]):
        fn.argtypes = [ctypes.c_void_p] * 7 + tail
    for fn in kernels.values():
        fn.restype = ctypes.c_int
    return kernels


def _aligned_as_launched(t, nbytes: int) -> bool:
    """Whether ``t`` reaches the kernels ``nbytes``-aligned: an f32
    contiguous tensor is launched in place, anything else as a fresh copy
    (``_f32``), which the allocator aligns."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t.data_ptr() % nbytes == 0
    return True


def _tiled_layout(value, loc) -> bool:
    """D a multiple of 4, at most 32 samples a (query, head), value 16-byte
    and the locations 8-byte aligned as launched: what both tiled kernels
    take."""
    samples = loc.shape[3] * loc.shape[4]
    return (value.shape[-1] % 4 == 0 and samples <= 32
            and _aligned_as_launched(value, 16)
            and _aligned_as_launched(loc, 8))


def _msda_fwd_variant(value, spatial_shapes, loc) -> str:
    """Which forward kernel (K7) takes these inputs, as ``csrc/msda.cu``
    documents: "tiled" (a block per (batch, head, patch of queries), two
    samples a warp instruction, 16-byte gathers: D a multiple of 4, at most
    32 samples a (query, head), value 16-byte and the locations 8-byte
    aligned as launched, S below 2^24 and S x H x D below 2^31) or "narrow"
    (a warp per (batch, query, head), lane = channel, one sample at a
    time). Depends on the shapes and the alignment alone, never on where
    the samples lie; launches nothing. Neither kernel takes D > 64 or more
    than 8 levels."""
    _, s, heads, d = value.shape
    if _tiled_layout(value, loc) and s < 2**24 and s * heads * d < 2**31:
        return "tiled"
    return "narrow"


def _msda_bwd_variant(value, spatial_shapes, loc) -> str:
    """Which backward kernel (K7b) takes these inputs, as ``csrc/msda.cu``
    documents: "tiled" (a block per (batch, head, chunk of queries), two
    samples a warp instruction, 16-byte gathers and vector adds: D a
    multiple of 4, at most 32 samples a (query, head), value 16-byte and
    the locations 8-byte aligned as launched) or "narrow" (a warp per
    (batch, query, head), lane = channel, scalar adds). Depends on the
    shapes and the alignment alone, never on where the samples lie;
    launches nothing. Neither kernel takes D > 64 or more than 8 levels."""
    return "tiled" if _tiled_layout(value, loc) else "narrow"


def _kernel_tail(value, spatial_shapes, loc):
    """The shape arguments, the level table (kept alive by the caller until
    the launch returns) and the stream."""
    b, s, heads, d = value.shape
    lq, n_levels, n_points = loc.shape[1], loc.shape[3], loc.shape[4]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the MSDA kernels take D <= {MAX_HEAD_DIM}, got "
                         f"D={d}")
    if n_levels > MAX_LEVELS:
        raise ValueError(f"the MSDA kernels take at most {MAX_LEVELS} "
                         f"levels, got {n_levels}")
    table = (ctypes.c_int * (2 * n_levels))(
        *[int(x) for hw in spatial_shapes for x in hw])
    return table, [b, s, heads, d, lq, n_levels, n_points, table,
                   torch.cuda.current_stream(value.device).cuda_stream]


def _launch(name, fn, args, narrow=False):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1
    if narrow:
        NARROW_LAUNCHES[name] += 1


def _f32(t):
    return t.float().contiguous()


def _msda_fwd_cuda(value, spatial_shapes, loc, wts):
    """K7: value [B, S, H, D], loc [B, Lq, H, L, P, 2], wts [B, Lq, H, L, P]
    on one card -> [B, Lq, H * D] f32."""
    narrow = _msda_fwd_variant(value, spatial_shapes, loc) == "narrow"
    value, loc, wts = _f32(value), _f32(loc), _f32(wts)
    b, _, heads, d = value.shape
    out = torch.empty((b, loc.shape[1], heads * d), dtype=torch.float32,
                      device=value.device)
    table, tail = _kernel_tail(value, spatial_shapes, loc)
    with torch.cuda.device(value.device):
        _launch("msda_fwd", _kernels()["fwd_narrow" if narrow else "fwd"],
                [t.data_ptr() for t in (value, loc, wts, out)] + tail,
                narrow)
    del table
    return out


def _msda_bwd_cuda(value, spatial_shapes, loc, wts, grad_out):
    """K7b: (grad_value, grad_loc, grad_wts), f32, from the forward's inputs
    and grad_out [B, Lq, H * D]."""
    narrow = _msda_bwd_variant(value, spatial_shapes, loc) == "narrow"
    value, loc, wts, grad_out = (_f32(t) for t in (value, loc, wts,
                                                   grad_out))
    if grad_out.data_ptr() % 16:   # the tiled kernel reads it 16 bytes a lane
        grad_out = grad_out.clone()
    grad_value = torch.zeros_like(value)   # the kernel adds into it
    grad_loc, grad_wts = torch.empty_like(loc), torch.empty_like(wts)
    table, tail = _kernel_tail(value, spatial_shapes, loc)
    with torch.cuda.device(value.device):
        _launch("msda_bwd", _kernels()["bwd_narrow" if narrow else "bwd"],
                [t.data_ptr() for t in (value, loc, wts, grad_out,
                                        grad_value, grad_loc, grad_wts)]
                + tail, narrow)
    del table
    return grad_value, grad_loc, grad_wts


class _MSDeformAttn(torch.autograd.Function):
    """Saves (value, locations, weights) and nothing else, so a checkpointed
    layer may run the forward twice. CPU tensors take the plain versions,
    CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, value, loc, wts, spatial_shapes):
        if value.device.type == "cpu":
            out = ms_deform_attn_reference(value, spatial_shapes, loc, wts)
        else:
            out = _msda_fwd_cuda(value, spatial_shapes, loc, wts)
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, wts)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, wts = ctx.saved_tensors
        if value.device.type == "cpu":
            grads = ms_deform_attn_backward_reference(
                value, ctx.spatial_shapes, loc, wts, grad_out)
        else:
            grads = _msda_bwd_cuda(value, ctx.spatial_shapes, loc, wts,
                                   grad_out)
        return (*grads, None)


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """Multi-scale deformable attention: [B, Lq, H * D] f32 from value
    [B, S, H, D], locations [B, Lq, H, L, P, 2] and weights
    [B, Lq, H, L, P]; see the module docstring. CUDA tensors run the hand
    kernels (D <= 64, at most 8 levels), CPU tensors the plain versions."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    return _MSDeformAttn.apply(value.float(), sampling_locations.float(),
                               attention_weights.float(), spatial_shapes)
