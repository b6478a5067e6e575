"""Detection task adapter (counterpart of
``simpleaicv_tpu/tasks/detection.py``): the DINO-DETR branch of
``make_detr_loss_fn``. The COCO evaluation waits for the decoder and the
evaluator."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["make_detr_loss_fn"]


def make_detr_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, for a
    DINO-DETR model on a collated batch ``{"image", "scaled_annots", ...}``:
    the model sees the annotations (for its denoising queries in training)
    and draws its noise from ``generator``. Returns the sum of the
    criterion's terms and the terms themselves as metrics."""

    def loss_fn(model, batch, generator, train):
        annots = batch["scaled_annots"]
        outs = model(batch["image"], annots, train, generator)
        loss_dict = criterion(outs, annots)
        total = torch.zeros((), dtype=torch.float32, device=annots.device)
        for value in loss_dict.values():
            total = total + value
        return total, dict(loss_dict)

    return loss_fn
