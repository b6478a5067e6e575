"""Learning-rate schedules as pure functions of the fractional epoch
(counterpart of ``simpleaicv_tpu/core/schedule.py``): linear warm-up followed
by MultiStepLR / CosineLR / PolyLR, evaluated at ``step / steps_per_epoch``
so that the rate moves every step. Stateless, on the host, in Python
floats: the optimizer asks for each step's rates before it launches the
update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    scheduler: str = "CosineLR"  # MultiStepLR | CosineLR | PolyLR
    lr: float = 0.1
    epochs: int = 100
    warm_up_epochs: int = 0
    # MultiStepLR
    milestones: Sequence[int] = ()
    gamma: float = 0.1
    # PolyLR
    power: float = 0.9
    # final floor (cosine decays to min_lr)
    min_lr: float = 0.0


def lr_at_epoch(cfg: SchedulerConfig, frac_epoch: float) -> float:
    """LR at a fractional epoch."""
    e = float(frac_epoch)
    warm = float(max(cfg.warm_up_epochs, 0))
    if warm > 0 and e < warm:
        return cfg.lr * e / warm

    t = min(max((e - warm) / max(cfg.epochs - warm, 1e-8), 0.0), 1.0)
    if cfg.scheduler == "MultiStepLR":
        return cfg.lr * cfg.gamma**sum(e >= m for m in cfg.milestones)
    if cfg.scheduler == "CosineLR":
        return cfg.min_lr + 0.5 * (cfg.lr - cfg.min_lr) * (
            1.0 + math.cos(math.pi * t))
    if cfg.scheduler == "PolyLR":
        return (cfg.lr - cfg.min_lr) * (1.0 - t)**cfg.power + cfg.min_lr
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")


def lr_fn_per_step(cfg: SchedulerConfig, steps_per_epoch: int):
    """Returns ``schedule(step) -> lr`` using fractional epochs."""

    def schedule(step):
        return lr_at_epoch(cfg, float(step) / float(max(steps_per_epoch, 1)))

    return schedule
