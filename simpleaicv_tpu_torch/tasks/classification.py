"""Classification task adapter for the engine (counterpart of
``simpleaicv_tpu/tasks/classification.py``): the engine owns the step; this
module owns the task's loss and eval functions and the metric accumulation.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.meters import AccMeter
from ..parallel.mesh import sum_over_ranks
from ..parallel.moe import moe_aux_loss


def make_loss_fn(criterion, moe_aux_weight: float = 0.01) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, on a batch
    ``{"image": [B, H, W, 3], "label": ...}``.

    In training the loss adds ``moe_aux_weight`` times the sum of the
    auxiliary losses the model's MoE layers keep from this forward
    (``parallel.moe.moe_aux_loss``; configs set ``config.moe_aux_weight``,
    which the Trainer passes). Dense models have none, so the term is 0.
    """

    def loss_fn(model, batch, generator, train):
        out = model(batch["image"], generator=generator if train else None)
        loss = criterion(out, batch["label"])
        if train:
            aux = moe_aux_loss(model)
            if aux is not None:
                loss = loss + moe_aux_weight * aux
        return loss, {}

    return loss_fn


def make_eval_fn(output_index=None) -> Callable:
    """Returns the eval function computing top-1/top-5 correct counts;
    examples with a label < 0 are padding and count for nothing. A model
    with several heads is evaluated on its output ``output_index`` (a
    distillation model's student: 1)."""

    def eval_fn(model, batch, generator, train):
        del generator, train
        logits = model(batch["image"])
        if output_index is not None:
            logits = logits[output_index]
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
    ``shard_fn`` puts a batch on the model's device. The counts are summed
    over the ranks, each of which read its share of the set."""
    meter = AccMeter()
    for batch in loader:
        m = eval_step(model, shard_fn(batch))
        meter.update(float(m["acc1_correct"]), float(m["acc5_correct"]),
                     float(m["n"]))
    (meter.acc1_correct_num, meter.acc5_correct_num,
     meter.sample_num) = sum_over_ranks([meter.acc1_correct_num,
                                         meter.acc5_correct_num,
                                         meter.sample_num]).tolist()
    acc1, acc5 = meter.compute()
    return {"acc1": acc1, "acc5": acc5, "key_metric": acc1}


evaluate.sums_over_ranks = True
