"""Separable bilinear resize as matmuls, and the nearest 2x upsample
(counterpart of ``simpleaicv_tpu/ops/upsample.py``).

Resizing one axis is a product with a small dense interpolation matrix
R [out, in], built in numpy as the JAX package builds it:
  * ``align_corners=True``: corners map to corners (torch
    ``F.interpolate(mode="bilinear", align_corners=True)``), with no
    antialiasing when shrinking;
  * ``align_corners=False``: half-pixel centres, edge-clamped taps when
    upsampling (``jax.image.resize(method="linear")``, torch
    ``align_corners=False``) and jax's antialiased triangle kernel when
    downsampling.
The matrix is cast to the input's dtype, as the JAX package casts it, so
bf16 activations meet bf16 weights; ``F.interpolate`` keeps exact weights
and would part from the JAX package in bf16. Each (size pair, device,
dtype) matrix is made once and kept: a copy from pageable host memory would
wait for the card's stream at every call.

The nearest 2x upsample is a repeat (its backward a reshape-sum).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize_bilinear", "upsample_nearest_2x"]


@lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool = False):
    """Dense [n_out, n_in] f32 bilinear interpolation matrix (the JAX
    package's ``_interp_matrix``)."""
    r = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        r[:, 0] = 1.0
        return r
    if align_corners:
        src = np.linspace(0.0, n_in - 1.0, n_out)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        w = (src - lo).astype(np.float32)
        r[np.arange(n_out), lo] += 1.0 - w
        r[np.arange(n_out), hi] += w
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


@lru_cache(maxsize=None)
def _matrix_on(n_in: int, n_out: int, align_corners: bool,
               device: torch.device, dtype: torch.dtype):
    """R^T [n_in, n_out] on ``device`` in ``dtype``; a normal tensor even
    when first asked for under ``torch.inference_mode``, so that a later
    call that records gradients may use it."""
    r = _interp_matrix(n_in, n_out, align_corners)
    with torch.inference_mode(False):
        return torch.from_numpy(r.T.copy()).to(device=device, dtype=dtype)


def _apply_axis(x, n_out: int, axis: int, align_corners: bool):
    """Contracts x's ``axis`` against R [out, in], keeping layout and
    dtype."""
    rt = _matrix_on(x.shape[axis], n_out, align_corners, x.device, x.dtype)
    return torch.matmul(x.movedim(axis, -1), rt).movedim(-1, axis)


def resize_bilinear(x, out_hw, spatial_axes=(1, 2),
                    align_corners: bool = False):
    """Bilinear-resize two axes of ``x`` to ``out_hw`` via matmuls.
    ``align_corners=False`` reproduces ``jax.image.resize(method="linear")``
    for any size pair (antialiased on downscale); ``True`` reproduces torch
    ``F.interpolate(mode="bilinear", align_corners=True)``."""
    ah, aw = spatial_axes
    h_out, w_out = out_hw
    if x.shape[ah] != h_out:
        x = _apply_axis(x, h_out, ah, align_corners)
    if x.shape[aw] != w_out:
        x = _apply_axis(x, w_out, aw, align_corners)
    return x


def upsample_nearest_2x(x, spatial_axes=(1, 2)):
    """Nearest 2x upsample of two axes as a repeat."""
    ah, aw = spatial_axes
    return x.repeat_interleave(2, dim=ah).repeat_interleave(2, dim=aw)
