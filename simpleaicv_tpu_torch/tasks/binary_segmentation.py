"""Binary-segmentation task adapter for salient-object detection
(counterpart of ``simpleaicv_tpu/tasks/binary_segmentation.py``): the sum of
a list of weighted losses, each also a metric, and the thresholded IoU,
precision, recall and F-beta of an evaluation.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..parallel.mesh import sum_over_ranks

__all__ = ["make_loss_fn", "make_eval_fn", "make_evaluate"]


def make_loss_fn(criterion_list: Sequence) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine;
    ``criterion_list`` is [(name, ratio, loss(pred, mask)), ...]. Returns
    the weighted sum and each loss under its name."""

    def loss_fn(model, batch, generator, train):
        pred = model(batch["image"], train=train,
                     generator=generator if train else None)
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        metrics = {}
        for name, ratio, loss in criterion_list:
            v = loss(pred, batch["mask"])
            metrics[name] = v
            total = total + ratio * v
        return total, metrics

    return loss_fn


def make_eval_fn(threshold: float = 0.5) -> Callable:
    """The eval function of one batch: the sums over its images of the IoU,
    precision and recall of the prediction and the mask, both thresholded
    at ``threshold``, and the image count."""

    def eval_fn(model, batch, generator, train):
        del generator, train
        pred = model(batch["image"], train=False)
        p = (pred[..., 0] > threshold).float()
        y = (batch["mask"] > threshold).float()
        inter = (p * y).sum(dim=(1, 2))
        union = p.sum(dim=(1, 2)) + y.sum(dim=(1, 2)) - inter
        return {
            "iou_sum": (inter / union.clamp(min=1e-4)).sum(),
            "precision_sum": (inter / p.sum(dim=(1, 2)).clamp(min=1e-4)
                              ).sum(),
            "recall_sum": (inter / y.sum(dim=(1, 2)).clamp(min=1e-4)).sum(),
            "n": torch.tensor(float(p.shape[0]), device=p.device),
        }

    return eval_fn


def make_evaluate(beta_sq: float = 0.3):
    """``evaluate(eval_step, model, loader, shard_fn)``: the mean IoU,
    precision and recall over the images and the F-beta of the two means
    (beta^2 = ``beta_sq``); ``key_metric`` is the mean IoU. The sums are
    summed over the ranks."""

    def evaluate(eval_step, model, loader, shard_fn) -> dict:
        iou = prec = rec = n = 0.0
        for batch in loader:
            m = eval_step(model, shard_fn(batch))
            iou += float(m["iou_sum"])
            prec += float(m["precision_sum"])
            rec += float(m["recall_sum"])
            n += float(m["n"])
        iou, prec, rec, n = sum_over_ranks([iou, prec, rec, n]).tolist()
        n = max(n, 1.0)
        p, r = prec / n, rec / n
        f = (1 + beta_sq) * p * r / max(beta_sq * p + r, 1e-4)
        return {"miou": iou / n, "precision": p, "recall": r,
                "f_squared_beta": f, "key_metric": iou / n}

    evaluate.sums_over_ranks = True
    return evaluate
