"""Semantic-segmentation task adapter (counterpart of
``simpleaicv_tpu/tasks/semantic_segmentation.py``), also the face- and
human-parsing CLIs': the train step's loss function, the per-batch class
areas of an evaluation and their accumulation into mIoU, precision, recall
and dice over the classes present.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["make_loss_fn", "make_eval_fn", "make_evaluate"]


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, on a batch
    ``{"image": [B, H, W, 3], "mask": [B, H, W]}``."""

    def loss_fn(model, batch, generator, train):
        out = model(batch["image"], train=train,
                    generator=generator if train else None)
        return criterion(out, batch["mask"]), {}

    return loss_fn


def make_eval_fn(num_classes: int, ignore_index=255) -> Callable:
    """The eval function of one batch: per-class areas of the intersection,
    the prediction and the ground truth over the valid pixels (labels other
    than ``ignore_index``; the collater pads the canvas with it). The areas
    are counts of pixels in f32, exact below 2^24 a batch; labels and
    predictions are clamped to [0, num_classes) as the JAX package clamps
    them."""

    def hist(x, weights):
        return torch.bincount(x.clamp(0, num_classes - 1), weights=weights,
                              minlength=num_classes)

    def eval_fn(model, batch, generator, train):
        del generator, train
        logits = model(batch["image"], train=False)
        pred = logits.argmax(dim=-1).reshape(-1)
        mask = batch["mask"].reshape(-1).long()
        if ignore_index is None:
            w = torch.ones_like(mask, dtype=torch.float32)
        else:
            w = (mask != ignore_index).float()
        return {"area_intersect": hist(pred, w * (pred == mask).float()),
                "area_pred": hist(pred, w),
                "area_gt": hist(mask, w)}

    return eval_fn


def make_evaluate(num_classes: int):
    """``evaluate(eval_step, model, loader, shard_fn)``: the areas summed on
    the host in float64 over the loader, then mIoU, mean precision, recall
    and dice in percent over the classes with ground truth; ``key_metric``
    is the mIoU. (The JAX package's also takes the ignore index, which
    only its eval function uses.)"""

    def evaluate(eval_step, model, loader, shard_fn) -> dict:
        tot_i = np.zeros(num_classes)
        tot_p = np.zeros(num_classes)
        tot_g = np.zeros(num_classes)
        for batch in loader:
            m = eval_step(model, shard_fn(batch))
            tot_i += m["area_intersect"].double().cpu().numpy()
            tot_p += m["area_pred"].double().cpu().numpy()
            tot_g += m["area_gt"].double().cpu().numpy()
        union = tot_p + tot_g - tot_i
        present = tot_g > 0
        iou = np.where(union > 0, tot_i / np.clip(union, 1e-9, None), 0.0)
        precision = np.where(tot_p > 0, tot_i / np.clip(tot_p, 1e-9, None), 0)
        recall = np.where(tot_g > 0, tot_i / np.clip(tot_g, 1e-9, None), 0)
        dice = np.where(tot_p + tot_g > 0,
                        2 * tot_i / np.clip(tot_p + tot_g, 1e-9, None), 0)

        def mean(v):
            return float(v[present].mean()) * 100 if present.any() else 0.0

        miou = mean(iou)
        return {"mean_iou": miou, "mean_precision": mean(precision),
                "mean_recall": mean(recall), "mean_dice": mean(dice),
                "key_metric": miou}

    return evaluate
