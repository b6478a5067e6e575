"""Distillation losses (counterpart of
``simpleaicv_tpu/losses/distillation.py``): ``KDLoss`` (KL of the student
from the teacher at temperature T, scaled by T^2), ``DMLLoss`` (the mean of
both directions) and ``L2Loss`` (feature MSE). Probabilities are clamped
to [1e-4, 1 - 1e-4] and the KL is ``batchmean``, as in the reference."""

from __future__ import annotations

import torch

from ..core.registry import LOSSES

__all__ = ["KDLoss", "DMLLoss", "L2Loss"]


def _clamped_probs(pred, T):
    p = torch.softmax(pred.float() / T, dim=-1)
    return torch.clamp(p, 1e-4, 1.0 - 1e-4)


def _kl_batchmean(log_s, p_t):
    """``F.kl_div(log_s, p_t, reduction='batchmean')``."""
    return (p_t * (torch.log(p_t) - log_s)).sum() / log_s.shape[0]


@LOSSES.register()
class KDLoss:

    def __init__(self, T: float = 1.0):
        self.T = T

    def __call__(self, stu_pred, tea_pred):
        log_s = torch.log(_clamped_probs(stu_pred, self.T))
        p_t = _clamped_probs(tea_pred, self.T)
        return _kl_batchmean(log_s, p_t) * self.T * self.T


@LOSSES.register()
class DMLLoss:

    def __init__(self, T: float = 1.0):
        self.T = T

    def __call__(self, stu_pred, tea_pred):
        kd = KDLoss(self.T)
        return (kd(stu_pred, tea_pred) + kd(tea_pred, stu_pred)) / 2.0


@LOSSES.register()
class L2Loss:

    def __call__(self, stu_feature, tea_feature):
        return (stu_feature.float() - tea_feature.float()).square().mean()
