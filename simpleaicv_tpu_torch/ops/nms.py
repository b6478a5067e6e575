"""Fixed-shape greedy NMS (counterpart of ``simpleaicv_tpu/ops/nms.py``),
with IoU or DIoU suppression.

The overlap matrix of the score-sorted candidates is built once, on the
boxes' device, in a few tensor ops. The greedy sweep over it (row i
suppresses the lower-ranked boxes it overlaps only if box i is itself
kept) is a chain of K dependent steps; it runs on the host, over the
boolean matrix copied there once per call for the whole batch, so it costs
no kernel launch per candidate. The keep set is that of sequential greedy
NMS in the stable order of ``argsort(-scores)``: a box is suppressed when
its overlap with a higher-ranked kept box is at least the threshold.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pairwise_iou", "pairwise_diou", "nms_keep_mask", "batched_nms"]


def pairwise_iou(boxes):
    """[..., K, 4] xyxy -> [..., K, K] IoU (union clipped at 1e-4)."""
    b1, b2 = boxes[..., :, None, :], boxes[..., None, :, :]
    omin = torch.maximum(b1[..., 0:2], b2[..., 0:2])
    omax = torch.minimum(b1[..., 2:4], b2[..., 2:4])
    owh = (omax - omin).clamp(min=0.0)
    overlap = owh[..., 0] * owh[..., 1]
    wh = (boxes[..., 2:4] - boxes[..., 0:2]).clamp(min=0.0)
    areas = wh[..., 0] * wh[..., 1]
    union = (areas[..., :, None] + areas[..., None, :] - overlap).clamp(
        min=1e-4)
    return overlap / union


def pairwise_diou(boxes):
    """[..., K, 4] xyxy -> [..., K, K] DIoU: IoU less the squared centre
    distance over the squared diagonal of the enclosing box."""
    iou = pairwise_iou(boxes)
    b1, b2 = boxes[..., :, None, :], boxes[..., None, :, :]
    emin = torch.minimum(b1[..., 0:2], b2[..., 0:2])
    emax = torch.maximum(b1[..., 2:4], b2[..., 2:4])
    ewh = (emax - emin).clamp(min=0.0)
    c2 = (ewh[..., 0]**2 + ewh[..., 1]**2).clamp(min=1e-4)
    ctr = (boxes[..., 0:2] + boxes[..., 2:4]) / 2
    p2 = ((ctr[..., :, None, :] - ctr[..., None, :, :])**2).sum(-1)
    return iou - p2 / c2


def _greedy_sweep(suppress: np.ndarray) -> np.ndarray:
    """[B, K, K] bool over score-sorted candidates -> keep [B, K]: row i
    clears the later candidates it suppresses while candidate i is kept."""
    b, k, _ = suppress.shape
    keep = np.ones((b, k), bool)
    later = np.triu(np.ones((k, k), bool), 1)
    rows = suppress & later
    for i in range(k):
        keep &= ~(rows[:, i] & keep[:, i:i + 1])
    return keep


def _keep_masks(boxes, scores, iou_threshold, nms_type):
    """[B, K, 4], [B, K] -> keep [B, K] (bool, on the boxes' device) in the
    candidates' own order."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    boxes_s = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    overlap = (pairwise_diou(boxes_s) if nms_type == "diou_python_nms"
               else pairwise_iou(boxes_s))
    keep_sorted = torch.from_numpy(_greedy_sweep(
        (overlap >= iou_threshold).cpu().numpy())).to(boxes.device)
    keep = torch.zeros_like(keep_sorted)
    return keep.scatter(-1, order, keep_sorted)


def nms_keep_mask(boxes, scores, iou_threshold: float = 0.5,
                  nms_type: str = "python_nms"):
    """Greedy NMS: [K, 4] xyxy boxes (in any order) and [K] scores -> keep
    mask [K], or a batch of them: [B, K, 4] and [B, K] -> [B, K].
    ``nms_type`` "diou_python_nms" suppresses by DIoU, any other by IoU."""
    if boxes.dim() == 2:
        return _keep_masks(boxes[None], scores[None], iou_threshold,
                           nms_type)[0]
    return _keep_masks(boxes, scores, iou_threshold, nms_type)


def batched_nms(boxes, scores, max_output: int = 100,
                iou_threshold: float = 0.5, nms_type: str = "python_nms"):
    """[B, K, 4], [B, K] -> (scores [B, M], indices [B, M], valid [B, M]),
    M = ``max_output``: the kept detections by descending score (ties: the
    lower index first); invalid slots have score -1 and index -1."""
    keep = _keep_masks(boxes, scores, iou_threshold, nms_type)
    masked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True,
                                     stable=True)
    pad = max(max_output - masked.shape[-1], 0)
    top_scores = F.pad(top_scores[:, :max_output], (0, pad),
                       value=-torch.inf)
    top_idx = F.pad(top_idx[:, :max_output], (0, pad))
    valid = top_scores > -torch.inf
    return (torch.where(valid, top_scores, torch.full_like(top_scores, -1.0)),
            torch.where(valid, top_idx, torch.full_like(top_idx, -1)), valid)
