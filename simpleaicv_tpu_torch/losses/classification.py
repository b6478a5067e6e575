"""Classification losses (counterpart of
``simpleaicv_tpu/losses/classification.py``). Each is a callable
``loss(pred_logits, label) -> f32 scalar``, computed in f32 whatever the
model's compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import LOSSES

__all__ = ["CELoss", "FocalCELoss", "LabelSmoothCELoss", "OneHotLabelCELoss",
           "SemanticSoftmaxLoss"]


def _log_softmax(pred):
    return F.log_softmax(pred.float(), dim=-1)


def _one_hot(label, n):
    return F.one_hot(label.long(), n).float()


def _smooth_ce(logp, label, smoothing):
    n = logp.shape[-1]
    smoothed = (1.0 - smoothing) * _one_hot(label, n) + smoothing / n
    return (-smoothed * logp).sum(dim=-1)


@LOSSES.register()
class CELoss:
    """Mean cross-entropy with integer labels."""

    def __call__(self, pred, label):
        logp = _log_softmax(pred)
        return -logp.gather(-1, label.long()[:, None])[:, 0].mean()


@LOSSES.register()
class FocalCELoss:

    def __init__(self, gamma: float = 2.0):
        self.gamma = gamma

    def __call__(self, pred, label):
        logp = _log_softmax(pred)
        p = torch.exp(logp)
        one_hot = _one_hot(label, pred.shape[-1])
        pt = torch.where(one_hot == 1.0, p, 1.0 - p)
        loss = torch.pow(1.0 - pt, self.gamma) * (-logp) * one_hot
        return loss.sum(dim=-1).mean()


@LOSSES.register()
class LabelSmoothCELoss:

    def __init__(self, smoothing: float = 0.1):
        self.smoothing = smoothing

    def __call__(self, pred, label):
        return _smooth_ce(_log_softmax(pred), label, self.smoothing).mean()


@LOSSES.register()
class OneHotLabelCELoss:
    """CE with one-hot / soft labels (used by mixup-cutmix training)."""

    def __call__(self, pred, target):
        return (-target.float() * _log_softmax(pred)).sum(dim=-1).mean()


@LOSSES.register()
class SemanticSoftmaxLoss:
    """ImageNet-21K hierarchical semantic softmax.

    ``semantic_outputs`` is a list of per-hierarchy logits; ``semantic_labels``
    is [B, n_hierarchies] with -1 for "not present at this level".
    """

    def __init__(self, normalization_factor_list, smoothing: float = 0.1):
        self.normalization_factor_list = normalization_factor_list
        self.smoothing = smoothing

    def __call__(self, semantic_outputs, semantic_labels):
        total = 0.0
        for i, out_i in enumerate(semantic_outputs):
            labels_i = semantic_labels[:, i]
            valid = (labels_i >= 0).float()
            ce = _smooth_ce(_log_softmax(out_i), labels_i.clamp(min=0),
                            self.smoothing) * valid
            total = total + ce.mean() * self.normalization_factor_list[i]
        return total
