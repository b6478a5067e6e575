"""Text-detection task adapter (counterpart of the loss function and the
per-epoch evaluation of ``tools/train_text_detection.py``): the loss of a
train step (``DBNetLoss``'s three terms, summed) and the polygon P/R/F1,
which runs the model in eval mode without gradients, copies the maps to
the host and decodes them there."""

from __future__ import annotations

from typing import Callable

import torch

from ..evaluation.text_eval import evaluate_text_detection
from .detection import _summed

__all__ = ["MAP_KEYS", "make_loss_fn", "evaluate_polygons"]

MAP_KEYS = ("probability_mask", "probability_ignore_mask", "threshold_mask",
            "threshold_ignore_mask")


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine: the
    criterion on the model's maps and the batch's four target maps."""

    def loss_fn(model, batch, generator, train):
        del generator
        preds = model(batch["image"], train=train)
        return _summed(criterion(preds, {k: batch[k] for k in MAP_KEYS}),
                       batch["image"].device)

    return loss_fn


@torch.no_grad()
def evaluate_polygons(model, decoder, loader, to_device: Callable) -> dict:
    """Polygon precision, recall and F1 (x 100; 'key_metric' the F1) of
    ``model`` over ``loader``, every ground truth counted (no ignore
    flags), as the JAX CLIs evaluate. The model's own mode is as before
    afterwards."""
    was_training = model.training
    model.eval()
    results = []
    try:
        for batch in loader:
            preds = model(to_device({"image": batch["image"]})["image"])
            for (boxes, _), gt_polys in zip(decoder(preds), batch["polys"]):
                results.append({"pred_polys": list(boxes),
                                "gt_polys": list(gt_polys),
                                "gt_ignore": [False] * len(gt_polys)})
    finally:
        model.train(was_training)
    stats = evaluate_text_detection(results)
    stats["key_metric"] = stats.get("f1", 0.0)
    return stats
