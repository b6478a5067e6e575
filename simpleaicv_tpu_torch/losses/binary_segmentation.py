"""Binary-segmentation losses for salient-object detection (counterpart of
``simpleaicv_tpu/losses/binary_segmentation.py``): BCE, OHEM-BCE, BCE-IoU
and BCE-Dice on sigmoid probabilities [b, h, w, 1] against masks
[b, h, w]. The probabilities are clipped to [1e-4, 1 - 1e-4] and the
logarithms taken of them, as in the JAX package (not BCE with logits).
"""

from __future__ import annotations

import torch

from ..core.registry import LOSSES

__all__ = ["BinaryBCELoss", "OHEMBCELoss", "BCEIouloss", "BCEDiceLoss"]


def _flat(pred, label, rows: int = 1):
    p = pred.float().reshape(rows, -1).clamp(1e-4, 1.0 - 1e-4)
    return p, label.float().reshape(rows, -1)


def _bce(p, y):
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


@LOSSES.register()
class BinaryBCELoss:

    def __call__(self, pred, label):
        return _bce(*_flat(pred, label)).mean()


@LOSSES.register()
class OHEMBCELoss:
    """BCE over the positives and the hardest negatives, at most
    ``negative_ratio`` times as many as the positives."""

    def __init__(self, negative_ratio: float = 1.5):
        self.negative_ratio = negative_ratio

    def __call__(self, pred, label):
        p, y = _flat(pred, label)
        p, y = p[0], y[0]
        pos = (y > 0).float()
        n_pos = pos.sum()
        n_neg = torch.minimum((1.0 - pos).sum(), n_pos * self.negative_ratio)
        loss = _bce(p, y)
        pos_loss = (loss * pos).sum()
        # descending as the JAX package takes it: a stable ascending sort,
        # reversed (tied losses in the same order)
        neg_sorted = torch.sort(loss * (1.0 - pos),
                                stable=True).values.flip(0)
        rank = torch.arange(neg_sorted.shape[0], dtype=torch.float32,
                            device=neg_sorted.device)
        neg_loss = torch.where(rank < n_neg, neg_sorted, 0.0).sum()
        return (pos_loss + neg_loss) / (n_pos + n_neg + 1e-4)


@LOSSES.register()
class BCEIouloss:

    def __init__(self, smooth: float = 1e-4):
        self.smooth = smooth

    def __call__(self, pred, label):
        p, y = _flat(pred, label, pred.shape[0])
        inter = (p * y).sum(dim=1)
        iou = 1.0 - (inter + self.smooth) / (
            p.sum(dim=1) + y.sum(dim=1) - inter + self.smooth)
        return iou.mean()


@LOSSES.register()
class BCEDiceLoss:

    def __init__(self, smooth: float = 1e-4):
        self.smooth = smooth

    def __call__(self, pred, label):
        p, y = _flat(pred, label, pred.shape[0])
        inter = (p * y).sum(dim=1)
        dice = 1.0 - (2 * inter + self.smooth) / (
            p.sum(dim=1) + y.sum(dim=1) + self.smooth)
        return dice.mean()
