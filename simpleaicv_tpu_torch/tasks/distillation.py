"""Distillation task adapter (counterpart of
``simpleaicv_tpu/tasks/distillation.py``).

``config.loss_list`` is the reference's: dicts with ``loss_name``,
``loss_ratio`` and the loss's own parameters. A loss named in
``_LABEL_LOSSES`` takes (student logits, labels), every other one (student,
teacher), as the reference's loop routes them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.registry import LOSSES

_LABEL_LOSSES = {"CELoss", "OneHotLabelCELoss", "LabelSmoothCELoss",
                 "FocalCELoss"}


def make_loss_fn(criterion_list) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine over a
    ``KDModel``; criterion_list: [(name, ratio, callable), ...]. Each loss's
    value is a metric under its name."""

    def loss_fn(model, batch, generator, train):
        tea, stu = model(batch["image"],
                         generator=generator if train else None)
        total = torch.zeros((), dtype=torch.float32, device=stu.device)
        metrics = {}
        for name, ratio, loss in criterion_list:
            v = loss(stu, batch["label"] if name in _LABEL_LOSSES else tea)
            metrics[name] = v.detach()
            total = total + ratio * v
        return total, metrics

    return loss_fn


def build_criterion_list(loss_list):
    """From the reference's ``config.loss_list`` dicts."""
    out = []
    for item in loss_list:
        name = item["loss_name"]
        ratio = item.get("loss_ratio", 1.0)
        params = {k: v for k, v in item.items()
                  if k not in ("loss_name", "loss_ratio")}
        out.append((name, ratio, LOSSES.create(name, **params)))
    return out
