"""SAM-matting loss stacks (counterpart of
``simpleaicv_tpu/losses/sam_matting.py``): ``SAMMattingOneLevelLoss``,
``SAMMattingMultiLevelLoss``, ``SAMMattingMultiLevelIoUMaxLoss`` and
``SAMMattingMultiLevelAssignLoss``.

The four stacks share eight terms over the SAM-matting model's outputs
(global trimap, local alpha, fused alpha, IoU prediction), each computed
per (sample, level) in ``_Terms``, and differ in how they reduce the level
axis:

* OneLevel and MultiLevel: plain means over the samples and levels;
* IoUMax: per sample, only the level whose thresholded fused alpha has the
  largest IoU with the thresholded ground truth;
* Assign: per sample, the levels whose ``area_ranges`` window holds the
  ground truth's area ratio (strict ``>`` and ``<``), averaged over those
  levels and then over the samples that have one. Three ratios gate: the
  alpha > 0 area for most terms, that area inside the unknown region for
  the local Laplacian term, and the thresholded alpha's area for the IoU
  prediction term.

Shapes, NHWC with a level axis: images [B, H, W, 3]; global [B, L, H, W, 3],
local and fused [B, L, H, W, 1], IoU [B, L] (OneLevel also takes them
without the level axis); alpha [B, H, W], trimap [B, H, W] (0/128/255),
fg_map and bg_map [B, H, W, 3].
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.registry import LOSSES
from .matting import (_charbonnier, _clip, _convert_trimap, _gauss_kernel,
                      conv_gauss, halve)

__all__ = ["SAMMattingOneLevelLoss", "SAMMattingMultiLevelLoss",
           "SAMMattingMultiLevelIoUMaxLoss", "SAMMattingMultiLevelAssignLoss"]

_EPS = 1e-4


def _lap_pyramid_l1(pred, alpha, levels=5):
    """Per-item Laplacian-pyramid L1 over a fixed 5 levels: pred and alpha
    [N, h, w] -> [N]."""
    kernel = torch.from_numpy(_gauss_kernel())[None, None].to(pred.device)
    a, b = pred[:, None], alpha[:, None]
    total = torch.zeros(pred.shape[0], device=pred.device)
    for _ in range(levels):
        fa, fb = conv_gauss(a, kernel), conv_gauss(b, kernel)
        total = total + ((a - fa) - (b - fb)).abs().mean(dim=(1, 2, 3))
        a, b = halve(fa), halve(fb)
    return total + (a - b).abs().mean(dim=(1, 2, 3))


def _as_leveled(x, rank):
    """A [B, L, ...] level axis (a one-level caller may pass [B, ...])."""
    return x[:, None] if x.dim() == rank - 1 else x


class _Terms:
    """The eight terms per (sample, level), and the gating ratios."""

    def __init__(self, images, preds, targets, mask_threshold):
        g, l, f, iou_pred = preds
        alpha, trimap, fg, bg = targets
        g, l, f = (_as_leveled(x, 5) for x in (g, l, f))
        iou_pred = _as_leveled(iou_pred, 2).float()
        if alpha.dim() == 4:
            alpha = alpha[..., 0]
        b, L, h, w = g.shape[:4]
        alpha = alpha.float()
        img = images.float()
        gp = _clip(g)
        lp = _clip(l)[..., 0]
        fp = _clip(f)[..., 0]
        onehot = F.one_hot(_convert_trimap(trimap), 3).float()[:, None]

        bce = -(onehot * torch.log(gp) + (1.0 - onehot) * torch.log(1.0 - gp))
        self.ce = bce.mean(dim=(2, 3, 4))

        inter = (gp * onehot).sum(-1)
        union = gp.sum(-1) + onehot.sum(-1) - inter
        self.iou = (1.0 - (inter + _EPS) / (union + _EPS)).mean(dim=(2, 3))

        wmask = (trimap == 128).float()[:, None]
        self.local_alpha_num = _charbonnier(
            (lp - alpha[:, None]) * wmask).sum(dim=(2, 3))
        self.wsum = wmask[:, 0].sum(dim=(1, 2))

        self.lap_local = _lap_pyramid_l1(
            (lp * wmask).reshape(b * L, h, w),
            (alpha[:, None] * wmask).expand(b, L, h, w).reshape(b * L, h, w)
        ).reshape(b, L)

        self.fusion_alpha = _charbonnier(fp - alpha[:, None]).mean(
            dim=(2, 3))
        self.lap_fused = _lap_pyramid_l1(
            fp.reshape(b * L, h, w),
            alpha[:, None].expand(b, L, h, w).reshape(b * L, h, w)
        ).reshape(b, L)

        comp = (fp[..., None] * fg[:, None]
                + (1.0 - fp[..., None]) * bg[:, None])
        self.comp = _charbonnier(comp - img[:, None]).mean(dim=(2, 3, 4))

        fbin = (fp >= mask_threshold).float()
        abin = (alpha[:, None] >= mask_threshold).float()
        binter = (fbin * abin).sum(dim=(2, 3))
        self.iou_gt = (binter + _EPS) / (fbin.sum(dim=(2, 3))
                                         + abin.sum(dim=(2, 3)) - binter
                                         + _EPS)
        self.iou_sq = (iou_pred - self.iou_gt)**2

        area = float(h * w)
        self.area_ratio = (alpha > 0).float().sum(dim=(1, 2)) / area
        # the reference's local Laplacian term gates on alpha inside the
        # unknown region, the only Assign term that does
        self.area_ratio_weighted = ((alpha > 0) & (wmask[:, 0] > 0)).float(
        ).sum(dim=(1, 2)) / area
        # the IoU-prediction term gates on the thresholded alpha
        self.area_ratio_thresh = abin[:, 0].sum(dim=(1, 2)) / area
        self.b, self.L = b, L


class _SAMMattingLossBase:
    """The weights, named as the reference's constructor names them (its
    'gloabel' included), and the packing of the eight terms."""

    def __init__(self,
                 global_pred_trimap_ce_loss_weight=1,
                 gloabel_pred_trimap_iou_loss_weight=1,
                 local_pred_alpha_loss_weight=1,
                 local_pred_laplacian_loss_weight=1,
                 fusion_pred_alpha_loss_weight=1,
                 fusion_pred_laplacian_loss_weight=1,
                 composition_loss_weight=1,
                 fused_pred_iou_predict_loss_weight=1,
                 mask_threshold=0.5):
        self.w_ce = global_pred_trimap_ce_loss_weight
        self.w_iou = gloabel_pred_trimap_iou_loss_weight
        self.w_local_alpha = local_pred_alpha_loss_weight
        self.w_local_lap = local_pred_laplacian_loss_weight
        self.w_fusion_alpha = fusion_pred_alpha_loss_weight
        self.w_fusion_lap = fusion_pred_laplacian_loss_weight
        self.w_comp = composition_loss_weight
        self.w_iou_pred = fused_pred_iou_predict_loss_weight
        self.mask_threshold = mask_threshold

    def _pack(self, ce, iou, local_alpha, local_lap, fusion_alpha, fusion_lap,
              comp, iou_pred):
        return {
            "global_pred_trimap_ce_loss": self.w_ce * ce,
            "gloabel_pred_trimap_iou_loss": self.w_iou * iou,
            "local_pred_alpha_loss": self.w_local_alpha * local_alpha,
            "local_pred_laplacian_loss": self.w_local_lap * local_lap,
            "fusion_pred_alpha_loss": self.w_fusion_alpha * fusion_alpha,
            "fusion_pred_laplacian_loss": self.w_fusion_lap * fusion_lap,
            "composition_loss": self.w_comp * comp,
            "fused_pred_iou_predict_loss": self.w_iou_pred * iou_pred,
        }


@LOSSES.register()
class SAMMattingOneLevelLoss(_SAMMattingLossBase):
    """Plain means; the local alpha term divides by L times the unknown
    pixels (+1), the IoU term by B and L."""

    def __call__(self, images, preds, targets):
        t = _Terms(images, preds, targets, self.mask_threshold)
        return self._pack(
            ce=t.ce.mean(), iou=t.iou.mean(),
            local_alpha=t.local_alpha_num.sum() / (t.L * t.wsum.sum() + 1.0),
            local_lap=t.lap_local.mean(),
            fusion_alpha=t.fusion_alpha.mean(),
            fusion_lap=t.lap_fused.mean(), comp=t.comp.mean(),
            iou_pred=t.iou_sq.sum() / t.b / t.L)


@LOSSES.register()
class SAMMattingMultiLevelLoss(SAMMattingOneLevelLoss):
    """Every level against the ground truth: OneLevel's reductions over the
    level axis."""


@LOSSES.register()
class SAMMattingMultiLevelIoUMaxLoss(_SAMMattingLossBase):
    """Per sample, the level whose thresholded fused alpha has the largest
    IoU with the thresholded alpha (the first on a tie); that IoU's
    epsilon sits in the union only."""

    def __call__(self, images, preds, targets):
        t = _Terms(images, preds, targets, self.mask_threshold)
        fp = _as_leveled(preds[2], 5).float()[..., 0]
        alpha = targets[0]
        if alpha.dim() == 4:
            alpha = alpha[..., 0]
        fbin = (fp >= self.mask_threshold).float()
        abin = (alpha[:, None].float() >= self.mask_threshold).float()
        inter = (fbin * abin).sum(dim=(2, 3))
        union = fbin.sum(dim=(2, 3)) + abin.sum(dim=(2, 3)) - inter + _EPS
        sel = torch.argmax(inter / union, dim=1)

        def pick(x):
            return torch.take_along_dim(x, sel[:, None], dim=1)[:, 0]

        return self._pack(
            ce=pick(t.ce).mean(), iou=pick(t.iou).mean(),
            local_alpha=pick(t.local_alpha_num).sum() / (t.wsum.sum() + 1.0),
            local_lap=pick(t.lap_local).mean(),
            fusion_alpha=pick(t.fusion_alpha).mean(),
            fusion_lap=pick(t.lap_fused).mean(), comp=pick(t.comp).mean(),
            iou_pred=pick(t.iou_sq).sum() / t.b)


@LOSSES.register()
class SAMMattingMultiLevelAssignLoss(_SAMMattingLossBase):
    """Per-sample level gating by the ground truth's area ratio; the
    masked level mean, then the masked sample mean (``max(n, 1)``
    guards)."""

    def __init__(self, *args, idx_nums: int = 4,
                 area_ranges: Sequence[Sequence[float]] = ((0.04, 0.64),
                                                           (0.0, 0.04),
                                                           (0.01, 0.25),
                                                           (0.16, 1.0)),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.idx_nums = idx_nums
        self.area_ranges = tuple(tuple(r) for r in area_ranges)
        assert len(self.area_ranges) == self.idx_nums

    def _masked_reduce(self, per_level, ratio):
        lo = torch.tensor([r[0] for r in self.area_ranges],
                          device=ratio.device)
        hi = torch.tensor([r[1] for r in self.area_ranges],
                          device=ratio.device)
        valid = ((ratio[:, None] > lo) & (ratio[:, None] < hi)).float()
        n_valid = valid.sum(1)
        per_sample = (per_level * valid).sum(1) / n_valid.clamp(min=1.0)
        n_samples = (n_valid > 0).float().sum()
        return per_sample.sum() / n_samples.clamp(min=1.0)

    def __call__(self, images, preds, targets):
        t = _Terms(images, preds, targets, self.mask_threshold)
        assert t.L == self.idx_nums, (t.L, self.idx_nums)
        r = t.area_ratio
        return self._pack(
            ce=self._masked_reduce(t.ce, r),
            iou=self._masked_reduce(t.iou, r),
            local_alpha=self._masked_reduce(
                t.local_alpha_num / (t.wsum[:, None] + 1.0), r),
            local_lap=self._masked_reduce(t.lap_local, t.area_ratio_weighted),
            fusion_alpha=self._masked_reduce(t.fusion_alpha, r),
            fusion_lap=self._masked_reduce(t.lap_fused, r),
            comp=self._masked_reduce(t.comp, r),
            iou_pred=self._masked_reduce(t.iou_sq, t.area_ratio_thresh))
