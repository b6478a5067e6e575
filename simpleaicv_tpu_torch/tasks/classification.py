"""Classification task adapter for the engine (counterpart of
``simpleaicv_tpu/tasks/classification.py``): the engine owns the step; this
module owns the task's loss and eval functions and the metric accumulation.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.meters import AccMeter


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, on a batch
    ``{"image": [B, H, W, 3], "label": ...}``.

    The JAX package adds ``moe_aux_weight`` times the load-balance losses
    that MoE backbones sow. Dense models sow none, so the term is zero for
    every backbone the port has; it comes with ``vit_moe``.
    """

    def loss_fn(model, batch, generator, train):
        out = model(batch["image"], generator=generator if train else None)
        return criterion(out, batch["label"]), {}

    return loss_fn


def make_eval_fn() -> Callable:
    """Returns the eval function computing top-1/top-5 correct counts;
    examples with a label < 0 are padding and count for nothing."""

    def eval_fn(model, batch, generator, train):
        del generator, train
        logits = model(batch["image"])
        labels = batch["label"]
        # the last five of a stable ascending sort, highest first, as the
        # JAX package takes them: among tied logits the highest index wins.
        # With fewer than 5 classes every class is in the top 5.
        top5 = torch.argsort(logits, dim=-1, stable=True)[
            :, -min(5, logits.shape[-1]):].flip(-1)
        correct1 = (top5[:, 0] == labels).float()
        correct5 = (top5 == labels[:, None]).any(dim=-1).float()
        valid = (labels >= 0).float()
        return {
            "acc1_correct": (correct1 * valid).sum(),
            "acc5_correct": (correct5 * valid).sum(),
            "n": valid.sum(),
        }

    return eval_fn


def evaluate(eval_step, model, loader, shard_fn) -> dict:
    """Host loop over the eval loader -> {'acc1': %, 'acc5': %};
    ``shard_fn`` puts a batch on the model's device."""
    meter = AccMeter()
    for batch in loader:
        m = eval_step(model, shard_fn(batch))
        meter.update(float(m["acc1_correct"]), float(m["acc5_correct"]),
                     float(m["n"]))
    acc1, acc5 = meter.compute()
    return {"acc1": acc1, "acc5": acc5, "key_metric": acc1}
