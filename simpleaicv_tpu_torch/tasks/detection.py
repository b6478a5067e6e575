"""Detection task adapter (counterpart of
``simpleaicv_tpu/tasks/detection.py``): the loss functions of a train step
(the criterion's named terms, summed) and the COCO evaluation, which runs
the model in eval mode without gradients, decodes on the device, rescales
the boxes to the original images by 1 / scale and feeds the numpy
COCO-mAP evaluator."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..evaluation.coco_eval import CocoMAPEvaluator

__all__ = ["make_loss_fn", "make_detr_loss_fn", "evaluate_coco"]


def _summed(loss_dict, device):
    total = torch.zeros((), dtype=torch.float32, device=device)
    for value in loss_dict.values():
        total = total + value
    return total, dict(loss_dict)


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, for a
    detector called as ``model(image, train=train)`` whose criterion takes
    the pixel 'annots' [B, M, 5]. Returns the sum of the criterion's terms
    and the terms themselves as metrics."""

    def loss_fn(model, batch, generator, train):
        del generator
        outs = model(batch["image"], train=train)
        return _summed(criterion(outs, batch["annots"]),
                       batch["image"].device)

    return loss_fn


def make_detr_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, for a
    DETR-family model on a collated batch ``{"image", "mask",
    "scaled_annots", ...}``: a DINO-DETR model (one with ``dn_number``)
    sees the annotations, for its denoising queries in training, a DETR
    model the padding mask; either draws its noise from ``generator``. The
    criterion takes the normalised 'scaled_annots'. Returns the sum of the
    criterion's terms and the terms themselves as metrics."""

    def loss_fn(model, batch, generator, train):
        annots = batch["scaled_annots"]
        second = annots if hasattr(model, "dn_number") else batch["mask"]
        outs = model(batch["image"], second, train, generator)
        return _summed(criterion(outs, annots), annots.device)

    return loss_fn


@torch.no_grad()
def evaluate_coco(model, decoder, loader, num_classes: int,
                  to_device: Callable) -> dict:
    """The COCO statistics of ``model`` over ``loader``, and 'key_metric':
    the mAP at IoU .5:.95 times 100. ``to_device`` puts a host batch on the
    model's device. A DETR-family decoder (``takes_sizes``) also takes the
    collater's 'size', by which it scales its normalised boxes. The
    model's own mode is as before afterwards."""
    evaluator = CocoMAPEvaluator(num_classes)
    was_training = model.training
    model.eval()
    try:
        for batch in loader:
            outs = model(to_device({"image": batch["image"]})["image"])
            if getattr(decoder, "takes_sizes", False):
                scores, classes, boxes = decoder(outs, batch["size"])
            else:
                scores, classes, boxes = decoder(outs)
            scales = np.asarray(batch["scale"])
            annots = np.asarray(batch["annots"])
            for i in range(scores.shape[0]):
                keep = scores[i] > -1
                scale = max(scales[i], 1e-8)
                gt = annots[i]
                gt_valid = gt[:, 4] >= 0
                evaluator.add_image(
                    boxes[i][keep] / scale, scores[i][keep],
                    classes[i][keep].astype(np.int32),
                    gt[gt_valid, :4] / scale,
                    gt[gt_valid, 4].astype(np.int32))
    finally:
        model.train(was_training)
    stats = evaluator.compute()
    stats["key_metric"] = stats.get(
        "IoU=0.5:0.95,area=all,maxDets=100,mAP", -1.0) * 100.0
    return stats
