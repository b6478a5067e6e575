"""Human-matting losses (counterpart of ``simpleaicv_tpu/losses/matting.py``):
trimap CE and IoU on the global 3-class branch, the unknown-region alpha L1
and Laplacian-pyramid losses on the local branch, the whole-image alpha and
Laplacian losses on the fused output, and the composition loss. Predictions
are NHWC: global [B, H, W, 3], local and fused [B, H, W, 1].

The trimap keeps the reference's coding: 0 background, 128 unknown (local),
255 foreground (global).

The pyramid is the JAX package's, as written there: its 5x5 Gaussian
kernel *sums* the two axes' squared exponentials (``_gauss_kernel``), the
edge padding replicates, each level halves by a 2x2 sum / 4 over whole
windows, and the depth is clamped so that every level keeps a pixel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import LOSSES
from ..parallel.mesh import global_sum, per_rank

__all__ = ["GlobalTrimapCELoss", "GloabelTrimapIouLoss", "LocalAlphaLoss",
           "LocalLaplacianLoss", "FusionAlphaLoss", "FusionLaplacianLoss",
           "CompositionLoss"]

_EPS = 1e-4


def _convert_trimap(trimap):
    """0 -> 0 (background), 255 -> 2 (foreground), else (128) -> 1
    (unknown), int64."""
    t = trimap.long()
    return torch.where(t == 255, 2, torch.where(t == 0, 0, 1))


def _clip(x):
    return x.float().clamp(_EPS, 1.0 - _EPS)


def _charbonnier(d):
    """sqrt(d^2 + 1e-12): |d| with a gradient of 0 at d = 0."""
    return torch.sqrt(d * d + 1e-12)


def _gauss_kernel(size=5, sigma=1.0):
    """The JAX package's kernel: the squared exponentials of the two
    coordinates summed, not multiplied, then normalised."""
    grid = np.mgrid[0:size, 0:size].T.astype(np.float32)
    g = np.exp((grid - size // 2)**2 / (-2 * sigma**2))**2
    k = np.sum(g, axis=2)
    return (k / k.sum()).astype(np.float32)


def conv_gauss(img, kernel):
    """img [N, 1, h, w] f32; replicate padding, then the 5x5 kernel."""
    pad = kernel.shape[-1] // 2
    img = F.pad(img, (pad, pad, pad, pad), mode="replicate")
    return F.conv2d(img, kernel)


def halve(img):
    """The 2x2 sum / 4 over whole windows (``reduce_window`` VALID)."""
    return F.avg_pool2d(img, 2)


def _kernel_on(x):
    return torch.from_numpy(_gauss_kernel())[None, None].to(x.device)


def _laplacian_pyramid(img, kernel, levels=5):
    """img [N, 1, h, w] -> the band levels and the last low-pass."""
    levels = min(levels, int(math.log2(max(min(img.shape[2],
                                               img.shape[3]), 2))))
    pyr = []
    current = img
    for _ in range(levels):
        filtered = conv_gauss(current, kernel)
        pyr.append(current - filtered)
        current = halve(filtered)
    pyr.append(current)
    return pyr


def _lap_loss(pred, alpha):
    """The summed means of |pyramid(alpha) - pyramid(pred)| over the
    levels; pred and alpha [B, H, W, 1]."""
    pred, alpha = pred.permute(0, 3, 1, 2), alpha.permute(0, 3, 1, 2)
    kernel = _kernel_on(pred)
    return sum((a - p).abs().mean() for a, p in zip(
        _laplacian_pyramid(alpha, kernel), _laplacian_pyramid(pred, kernel)))


def _one_hot_trimap(trimap):
    return F.one_hot(_convert_trimap(trimap).reshape(-1), 3).float()


@LOSSES.register()
class GlobalTrimapCELoss:

    def __call__(self, global_pred, trimap):
        p = _clip(global_pred).reshape(-1, 3)
        y = _one_hot_trimap(trimap)
        return (-(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))).mean()


@LOSSES.register()
class GloabelTrimapIouLoss:
    """The reference's name, misspelt, is its registry name."""

    def __init__(self, smooth=1e-4):
        self.smooth = smooth

    def __call__(self, global_pred, trimap):
        p = _clip(global_pred).reshape(-1, 3)
        y = _one_hot_trimap(trimap)
        inter = (p * y).sum(1)
        iou = 1.0 - (inter + self.smooth) / (
            p.sum(1) + y.sum(1) - inter + self.smooth)
        return iou.mean()


@LOSSES.register()
class LocalAlphaLoss:

    def __call__(self, local_pred, alpha, trimap):
        p = _clip(local_pred)[..., 0]
        w = (trimap == 128).float()
        return (_charbonnier((p - alpha.float()) * w).sum()
                / per_rank(global_sum(w.sum()) + 1.0))


@LOSSES.register()
class LocalLaplacianLoss:

    def __call__(self, local_pred, alpha, trimap):
        w = (trimap == 128).float()[..., None]
        return _lap_loss(_clip(local_pred) * w, alpha.float()[..., None] * w)


@LOSSES.register()
class FusionAlphaLoss:

    def __call__(self, fusion_pred, alpha):
        return _charbonnier(_clip(fusion_pred)[..., 0]
                            - alpha.float()).mean()


@LOSSES.register()
class FusionLaplacianLoss:

    def __call__(self, fusion_pred, alpha):
        return _lap_loss(_clip(fusion_pred), alpha.float()[..., None])


@LOSSES.register()
class CompositionLoss:
    """|image * pred - image * alpha|, Charbonnier, over the foreground
    composite."""

    def __call__(self, fusion_pred, alpha, image):
        img = image.float()
        diff = img * fusion_pred.float() - img * alpha.float()[..., None]
        return _charbonnier(diff).mean()
