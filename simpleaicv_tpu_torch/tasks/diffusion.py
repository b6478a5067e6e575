"""Diffusion task adapter (counterpart of
``simpleaicv_tpu/tasks/diffusion.py``): the DDPM loss of a train step,
with the class-label drop of conditional training, the generation of
images by a DDPM or DDIM sampler, and the MSE and L1 criteria.

Every draw (the dropped labels, the time steps, the noise, dropout) comes
from the engine's step generator, in that order; the JAX loss splits its key
into one per draw instead, so the two give other numbers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["make_loss_fn", "make_generate_fn", "drop_labels", "MSELoss",
           "L1Loss"]


def drop_labels(class_label, drop_prob: float, generator=None):
    """Labels shifted by one (0 is the unconditional token); with
    ``drop_prob`` > 0 each is replaced by 0 with that probability, drawn
    from ``generator``."""
    if drop_prob <= 0.0:
        return class_label + 1
    drop = torch.rand(class_label.shape, device=class_label.device,
                      generator=generator) < drop_prob
    return torch.where(drop, 0, class_label + 1)


def make_loss_fn(criterion, trainer, num_classes: Optional[int] = None,
                 class_label_drop_prob: float = 0.0) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine: the
    criterion between the UNet's predicted noise and the noise of
    ``trainer`` (a ``DDPMTrainer``) on batch['image'] (in [-1, 1]), the
    UNet conditioned on batch['label'] when ``num_classes`` is set."""

    def loss_fn(model, batch, generator, train):
        class_label = batch.get("label") if num_classes else None
        if class_label is not None:
            class_label = drop_labels(class_label, class_label_drop_prob,
                                      generator)

        def model_fn(x_noisy, t, cl):
            return model(x_noisy, t, cl, train, generator)

        pred, noise = trainer(model_fn, batch["image"], generator,
                              class_label)
        return criterion(pred, noise), {}

    return loss_fn


def make_generate_fn(model, sampler, shape, device="cuda") -> Callable:
    """``generate(generator, class_label=None) -> images [N, H, W, C]`` in
    [-1, 1] (unclipped) by ``sampler`` from ``model`` in eval mode without
    gradients, on ``device``."""

    @torch.no_grad()
    def generate(generator=None, class_label=None):
        was_training = model.training
        model.eval()
        try:
            return sampler(lambda x, t, cl: model(x, t, cl, False), shape,
                           generator, class_label, device=device)
        finally:
            model.train(was_training)

    return generate


class MSELoss:

    def __call__(self, pred, label):
        return torch.mean((pred.float() - label.float()) ** 2)


class L1Loss:

    def __call__(self, pred, label):
        return torch.mean(torch.abs(pred.float() - label.float()))
