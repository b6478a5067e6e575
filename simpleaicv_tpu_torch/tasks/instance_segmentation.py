"""Instance-segmentation task adapter (counterpart of
``simpleaicv_tpu/tasks/instance_segmentation.py`` and of the JAX train
CLI's loss function): the loss of a train step (the criterion's named
terms, summed) and the COCO 'segm' mask mAP, which runs the model in eval
mode without gradients, decodes on the device and scores the masks against
the collater's ground-truth masks on their grid: the decoded masks are
average-pooled down to it and thresholded at 0.5."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..evaluation.coco_eval import CocoMAPEvaluator
from .detection import _summed

__all__ = ["make_loss_fn", "evaluate_coco_segm"]


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine: the
    criterion on the model's outputs, the pixel or relative 'annots' and
    the collater's 'gt_masks'. Returns the sum of the criterion's terms and
    the terms themselves as metrics."""

    def loss_fn(model, batch, generator, train):
        del generator
        outs = model(batch["image"], train=train)
        return _summed(criterion(outs, batch["annots"], batch["gt_masks"]),
                       batch["image"].device)

    return loss_fn


@torch.no_grad()
def evaluate_coco_segm(model, decoder, loader, num_classes: int,
                       to_device: Callable) -> dict:
    """The COCO 'segm' statistics of ``model`` over ``loader`` and
    'key_metric' (the mAP at IoU .5:.95 times 100). The decoder returns
    (masks [B, K, H, W] bool, labels [B, K], scores [B, K]) padded with -1.
    The model's own mode is as before afterwards."""
    evaluator = CocoMAPEvaluator(num_classes, iou_type="segm")
    was_training = model.training
    model.eval()
    try:
        for batch in loader:
            outs = model(to_device({"image": batch["image"]})["image"])
            det_masks, det_labels, det_scores = decoder(outs)
            gt_masks = np.asarray(batch["gt_masks"])
            annots = np.asarray(batch["annots"])
            scales = np.asarray(batch.get(
                "scale", np.ones(det_scores.shape[0], np.float32)))
            mr = gt_masks.shape[-1]
            down = det_masks.shape[-1] / mr if det_masks.size else 4.0
            for i in range(det_scores.shape[0]):
                keep = det_scores[i] > 0
                dm = det_masks[i][keep].astype(np.float32)
                if dm.shape[0] > 0 and dm.shape[-1] != mr:
                    f = dm.shape[-1] // mr
                    dm = dm[:, :f * mr, :f * mr].reshape(
                        dm.shape[0], mr, f, mr, f).mean(axis=(2, 4))
                dm = dm > 0.5
                gt_valid = annots[i, :, 4] >= 0
                evaluator.add_image(
                    det_scores=det_scores[i][keep],
                    det_classes=det_labels[i][keep].astype(np.int32),
                    gt_classes=annots[i, gt_valid, 4].astype(np.int32),
                    det_masks=dm.reshape((-1, mr, mr)),
                    gt_masks=gt_masks[i][gt_valid],
                    area_scale=float(down / max(scales[i], 1e-8)) ** 2)
    finally:
        model.train(was_training)
    stats = evaluator.compute()
    stats["key_metric"] = stats.get(
        "IoU=0.5:0.95,area=all,maxDets=100,mAP", -1.0) * 100.0
    return stats
