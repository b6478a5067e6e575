"""MAE self-supervised task adapter (counterpart of
``simpleaicv_tpu/tasks/mae.py``): loss only, no evaluation."""

from __future__ import annotations

from typing import Callable


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)``: the masked-patch loss of
    the model's prediction against the image's own patches; in training the
    mask noise comes from the step's generator."""

    def loss_fn(model, batch, generator, train):
        pred, mask = model(batch["image"],
                           generator=generator if train else None)
        target = model.images_to_patch(batch["image"])
        return criterion(pred, target, mask), {}

    return loss_fn
