"""Separable bilinear resize as matmuls (counterpart of
``simpleaicv_tpu/ops/upsample.py``).

Resizing one axis is a product with a small dense interpolation matrix
R [out, in], built in numpy with the JAX package's half-pixel semantics:
edge-clamped taps when upsampling (``jax.image.resize(method="linear")``,
torch ``align_corners=False``) and jax's antialiased triangle kernel when
downsampling. The JAX package's ``align_corners=True`` variant is not
ported yet: nothing on the served path uses it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize_bilinear"]


@lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int):
    """Dense [n_out, n_in] f32 half-pixel bilinear interpolation matrix (the
    JAX package's ``_interp_matrix`` with ``align_corners=False``)."""
    r = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        r[:, 0] = 1.0
        return r
    scale = n_in / n_out
    if scale <= 1.0:
        src = (np.arange(n_out) + 0.5) * scale - 0.5
        lo = np.floor(src).astype(np.int64)
        w = (src - lo).astype(np.float32)
        lo_c = np.clip(lo, 0, n_in - 1)
        hi_c = np.clip(lo + 1, 0, n_in - 1)
        r[np.arange(n_out), lo_c] += 1.0 - w
        r[np.arange(n_out), hi_c] += w
        return r
    # downscale: antialiased triangle kernel of half-width `scale`, sampled
    # at half-pixel centres and normalised
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    idx = np.arange(n_in)[None, :]
    t = np.maximum(0.0, 1.0 - np.abs(idx - src[:, None]) / scale)
    r[:] = (t / t.sum(axis=1, keepdims=True)).astype(np.float32)
    return r


def _apply_axis(x, r_np, axis: int):
    """Contracts x's ``axis`` against r [out, in], keeping layout and dtype."""
    r = torch.from_numpy(r_np).to(device=x.device, dtype=x.dtype)
    return torch.matmul(x.movedim(axis, -1), r.T).movedim(-1, axis)


def resize_bilinear(x, out_hw, spatial_axes=(1, 2)):
    """Bilinear-resize two axes of ``x`` to ``out_hw`` via matmuls,
    reproducing ``jax.image.resize(method="linear")`` for any size pair
    (antialiased on downscale)."""
    ah, aw = spatial_axes
    h_out, w_out = out_hw
    if x.shape[ah] != h_out:
        x = _apply_axis(x, _interp_matrix(x.shape[ah], h_out), ah)
    if x.shape[aw] != w_out:
        x = _apply_axis(x, _interp_matrix(x.shape[aw], w_out), aw)
    return x
