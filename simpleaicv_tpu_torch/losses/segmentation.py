"""Semantic-segmentation losses (counterpart of
``simpleaicv_tpu/losses/segmentation.py``): CE, multi-class BCE, IoU, Dice
and Lovasz on NHWC logits [b, h, w, c] against int labels [b, h, w], each
with an optional ``ignore_index``, and their weighted sum.

As in the JAX package, probabilities (softmax or sigmoid, in f32) are
clipped to [1e-4, 1 - 1e-4] before any logarithm, and ignored pixels are
weighted out by a validity mask (labels below 0 or equal to
``ignore_index``) rather than filtered. The JAX CE multiplies ``-log(p)`` by
a one-hot of the clamped label; only one term of each row is non-zero, so
``SegCELoss`` gathers that term instead, with an int64 index, and builds no
second tensor of the logits' size.
"""

from __future__ import annotations

import torch

from ..core.registry import LOSSES

__all__ = ["SegCELoss", "SegMultiClassBCELoss", "SegIoULoss", "SegDiceLoss",
           "SegLovaszLoss", "SegCombinedLoss"]

_EPS = 1e-4


def _probs(pred, logit: str):
    """[n, c] f32 clipped probabilities of NHWC logits."""
    pred = pred.reshape(-1, pred.shape[-1]).float()
    p = torch.softmax(pred, dim=-1) if logit == "softmax" else \
        torch.sigmoid(pred)
    return p.clamp(_EPS, 1.0 - _EPS)


def _labels(label, num_classes: int, ignore_index):
    """(labels [n] int64, the clamped labels [n, 1], validity [n] f32)."""
    label = label.reshape(-1).long()
    if ignore_index is not None:
        valid = (label >= 0) & (label != ignore_index)
    else:
        valid = torch.ones_like(label, dtype=torch.bool)
    return label, label.clamp(0, num_classes - 1)[:, None], valid.float()


def _masked_mean(loss, valid):
    return (loss * valid).sum() / valid.sum().clamp(min=1.0)


@LOSSES.register()
class SegCELoss:

    def __init__(self, ignore_index=None):
        self.ignore_index = ignore_index

    def __call__(self, pred, label):
        c = pred.shape[-1]
        _, index, valid = _labels(label, c, self.ignore_index)
        p = torch.softmax(pred.reshape(-1, c).float(), dim=-1)
        p = p.gather(1, index)[:, 0].clamp(_EPS, 1.0 - _EPS)
        return _masked_mean(-torch.log(p), valid)


@LOSSES.register()
class SegMultiClassBCELoss:

    def __init__(self, ignore_index=None):
        self.ignore_index = ignore_index

    def __call__(self, pred, label):
        c = pred.shape[-1]
        p = _probs(pred, "sigmoid")
        _, index, valid = _labels(label, c, self.ignore_index)
        oh = torch.zeros_like(p).scatter_(1, index, 1.0)
        bce = -(oh * torch.log(p) + (1.0 - oh) * torch.log(1.0 - p))
        return _masked_mean(bce.mean(dim=-1), valid)


@LOSSES.register()
class SegIoULoss:

    def __init__(self, logit_type="softmax", ignore_index=None):
        self.logit_type = logit_type
        self.ignore_index = ignore_index

    def __call__(self, pred, label):
        c = pred.shape[-1]
        p = _probs(pred, self.logit_type)
        _, index, valid = _labels(label, c, self.ignore_index)
        inter = p.gather(1, index)[:, 0]
        union = (p.sum(dim=-1) + 1.0 - inter).clamp(min=_EPS)
        return _masked_mean(1.0 - inter / union, valid)


@LOSSES.register()
class SegDiceLoss:

    def __init__(self, logit_type="softmax", ignore_index=None):
        self.logit_type = logit_type
        self.ignore_index = ignore_index

    def __call__(self, pred, label):
        c = pred.shape[-1]
        p = _probs(pred, self.logit_type)
        _, index, valid = _labels(label, c, self.ignore_index)
        inter = p.gather(1, index)[:, 0]
        dice = 1.0 - (2 * inter + _EPS) / (p.sum(dim=-1) + 1.0 + _EPS)
        return _masked_mean(dice, valid)


@LOSSES.register()
class SegLovaszLoss:
    """Sigmoid Lovasz-hinge-style loss over classes 1..C-1. Ignored pixels
    sort last (error -1, a stable sort) and add nothing through the sorted
    validity mask; a class absent from the valid pixels counts for
    nothing."""

    def __init__(self, ignore_index=None):
        self.ignore_index = ignore_index

    def __call__(self, pred, label):
        c = pred.shape[-1]
        p = _probs(pred, "sigmoid")
        label, _, valid = _labels(label, c, self.ignore_index)
        total = p.new_zeros(())
        count = p.new_zeros(())
        for class_idx in range(1, c):
            mask = ((label == class_idx) & (valid > 0)).float()
            present = (mask.sum() > 0).float()
            errors = (mask - p[:, class_idx]).abs()
            errors = torch.where(valid > 0, errors, -1.0)
            order = torch.argsort(-errors, stable=True)
            errors_sorted = errors[order]
            mask_sorted = mask[order]
            valid_sorted = valid[order]
            gts = mask_sorted.sum()
            inter = gts - mask_sorted.cumsum(0)
            union = gts + ((1.0 - mask_sorted) * valid_sorted).cumsum(0)
            jaccard = 1.0 - inter / union.clamp(min=_EPS)
            grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
            loss = (errors_sorted * valid_sorted * grad).sum()
            total = total + present * loss
            count = count + present
        return total / count.clamp(min=1.0)


@LOSSES.register()
class SegCombinedLoss:
    """Weighted sum of registered segmentation losses: ``loss_cfg`` is a
    list of (name, ratio, kwargs)."""

    def __init__(self, loss_cfg):
        self.parts = [(name, ratio, LOSSES.create(name, **kw))
                      for name, ratio, kw in loss_cfg]

    def __call__(self, pred, label):
        total = 0.0
        for _, ratio, loss in self.parts:
            total = total + ratio * loss(pred, label)
        return total
