"""SAM interactive-segmentation task adapter (counterpart of
``simpleaicv_tpu/tasks/interactive_segmentation.py``): the loss function of
one train step, the no-grad best-mask prediction and the error-region click
that the trainer's refinement loop puts between two steps on a point batch,
and the eval meter.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["make_loss_fn", "sample_error_region_points",
           "make_predict_best_mask_fn", "SegmentationEvalMeter"]

PROMPT_KEYS = ("prompt_point", "prompt_box", "prompt_mask")


def make_loss_fn(criterion, mask_out_idxs=(0, 1, 2, 3)) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine, on a batch
    ``{"image", "mask", "prompt_point", "prompt_box", "prompt_mask"}`` whose
    prompt entries may be None. One refinement iteration: the trainer's loop
    feeds the updated prompts in ``batch``. Returns the sum of the
    criterion's terms and the terms themselves as metrics."""

    def loss_fn(model, batch, generator, train):
        del generator  # SAM draws nothing in its forward
        prompts = {key: batch.get(key) for key in PROMPT_KEYS}
        masks, ious = model(batch["image"], prompts, mask_out_idxs, train)
        loss_dict = criterion((masks, ious), batch["mask"])
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["image"].device)
        for value in loss_dict.values():
            total = total + value
        return total, dict(loss_dict)

    return loss_fn


@torch.no_grad()
def sample_error_region_points(pred_masks, gt_masks, prev_points,
                               generator=None, min_error_pixels: int = 10):
    """Adds one refinement click per image at a uniformly drawn pixel of the
    error region (false positives and false negatives of the thresholded
    prediction), written into the first free (label -1) slot so that the
    prompt tensor keeps its shape; the last slot is overwritten when none is
    free. The click's label is the ground truth's at that pixel. An image
    whose error region has fewer than ``min_error_pixels`` pixels keeps its
    previous points.

    The pixel is the arg-max of the error mask times uniform noise in
    [1e-6, 1) drawn from ``generator``, which is uniform over the error
    pixels; ``generator=None`` gives the deterministic arg-max (the first
    error pixel). Fixed shapes, no host synchronisation.

    pred_masks [B, 1, H, W] logits; gt_masks [B, H, W]; prev_points
    [B, N, 3] as (x, y, label).
    """
    b, _, h, w = pred_masks.shape
    n = prev_points.shape[1]
    gt = gt_masks.float().reshape(b, -1)
    err = ((pred_masks[:, 0] > 0).float().reshape(b, -1) - gt).abs()
    score = err
    if generator is not None:
        noise = torch.rand(err.shape, generator=generator, device=err.device)
        score = err * (1e-6 + (1.0 - 1e-6) * noise)
    flat_idx = score.argmax(dim=1)
    new_pt = torch.stack([(flat_idx % w).float(),
                          torch.div(flat_idx, w, rounding_mode="floor"
                                    ).float(),
                          gt.gather(1, flat_idx[:, None])[:, 0]], dim=1)

    is_free = prev_points[:, :, 2] < 0
    slot = torch.where(is_free.any(dim=1), is_free.float().argmax(dim=1),
                       torch.full_like(flat_idx, n - 1))
    chosen = torch.arange(n, device=slot.device)[None, :] == slot[:, None]
    enough = err.sum(dim=1) >= min_error_pixels
    write = (chosen & enough[:, None])[:, :, None]
    return torch.where(write, new_pt[:, None, :].to(prev_points.dtype),
                       prev_points)


def make_predict_best_mask_fn() -> Callable:
    """``predict(model, images, points) -> [B, 1, H, W]``: the logits of the
    mask level with the highest predicted IoU, for sampling refinement
    points. Runs in eval mode without gradients on the device the model and
    the inputs lie on; the model's own mode is as before afterwards."""

    @torch.no_grad()
    def predict(model, images, points):
        prompts = {"prompt_point": points, "prompt_box": None,
                   "prompt_mask": None}
        masks, ious = model(images, prompts, (0, 1, 2, 3), False)
        best = ious.argmax(dim=-1)
        rows = torch.arange(masks.shape[0], device=masks.device)
        return masks[rows, best][:, None]

    return predict


class SegmentationEvalMeter:
    """Accumulates IoU, precision and recall of binary masks over batches."""

    def __init__(self):
        self.iou_sum = 0.0
        self.precision_sum = 0.0
        self.recall_sum = 0.0
        self.n = 0

    def update(self, pred_bin, gt):
        if isinstance(pred_bin, torch.Tensor):
            pred_bin = pred_bin.detach().cpu().numpy()
        if isinstance(gt, torch.Tensor):
            gt = gt.detach().cpu().numpy()
        pred_bin = np.asarray(pred_bin).astype(np.float32)
        gt = np.asarray(gt).astype(np.float32)
        inter = (pred_bin * gt).sum(axis=(-2, -1))
        pred_area = pred_bin.sum(axis=(-2, -1))
        gt_area = gt.sum(axis=(-2, -1))
        union = pred_area + gt_area - inter
        self.iou_sum += float((inter / np.clip(union, 1e-4, None)).sum())
        self.precision_sum += float(
            (inter / np.clip(pred_area, 1e-4, None)).sum())
        self.recall_sum += float((inter / np.clip(gt_area, 1e-4, None)).sum())
        self.n += pred_bin.shape[0]

    def compute(self):
        n = max(self.n, 1)
        return {"iou": self.iou_sum / n, "precision": self.precision_sum / n,
                "recall": self.recall_sum / n}
