"""MAE pretraining losses (counterpart of ``simpleaicv_tpu/losses/mae.py``):
the per-patch MSE or L1 over the masked patches only, in f32, divided by
``sum(mask) + 1e-4``. Each is ``loss(pred, target, mask)``."""

from __future__ import annotations

from ..core.registry import LOSSES
from ..parallel.mesh import global_sum, per_rank

__all__ = ["MAEMSELoss", "MAEL1Loss"]


@LOSSES.register()
class MAEMSELoss:

    def __call__(self, pred, label, mask):
        loss = (pred.float() - label.float()).square().mean(dim=-1)
        return (loss * mask).sum() / per_rank(global_sum(mask.sum()) + 1e-4)


@LOSSES.register()
class MAEL1Loss:

    def __call__(self, pred, label, mask):
        loss = (pred.float() - label.float()).abs()
        return (loss * mask).sum() / per_rank(global_sum(mask.sum()) + 1e-4)
