"""Text-detection polygon precision, recall and F1 (counterpart of
``simpleaicv_tpu/evaluation/text_eval.py``): each prediction matched one to
one to an unused ground-truth polygon by IoU over the two polygons
rasterised with ``data.raster.fill_poly`` (OpenCV's ``fillPoly``), at IoU
0.5; a prediction matched to an ignored ground truth counts neither way.

``evaluate_widerface_style``: the WIDER FACE easy, medium and hard APs,
each the VOC AP of ``data/datasets/voc.py`` over one subset's results,
and their mean.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..data.datasets.voc import evaluate_voc_detection
from ..data.raster import fill_poly

__all__ = ["evaluate_text_detection", "evaluate_widerface_style"]


def _poly_iou(p1, p2):
    pts = np.concatenate([p1.reshape(-1, 2), p2.reshape(-1, 2)], 0)
    w = int(pts[:, 0].max()) + 2
    h = int(pts[:, 1].max()) + 2
    m1 = fill_poly(np.zeros((h, w), np.uint8),
                   p1.astype(np.int32).reshape(-1, 2), 1)
    m2 = fill_poly(np.zeros((h, w), np.uint8),
                   p2.astype(np.int32).reshape(-1, 2), 1)
    inter = np.logical_and(m1, m2).sum()
    union = np.logical_or(m1, m2).sum()
    return inter / max(union, 1)


def evaluate_text_detection(per_image_results: Sequence[dict],
                            iou_threshold: float = 0.5) -> dict:
    """per_image_results: dicts with 'pred_polys' (a list of [N, 2]),
    'gt_polys' and 'gt_ignore' (bools). Returns precision, recall, f1 and
    'key_metric' (f1), each x 100."""
    n_match = n_pred = n_gt = 0
    for r in per_image_results:
        preds: List[np.ndarray] = list(r["pred_polys"])
        gts = list(r["gt_polys"])
        ignore = list(r.get("gt_ignore", [False] * len(gts)))
        gt_used = [False] * len(gts)
        for p in preds:
            best_iou, best_g = iou_threshold, -1
            for g, gt in enumerate(gts):
                if gt_used[g]:
                    continue
                iou = _poly_iou(np.asarray(p), np.asarray(gt))
                if iou >= best_iou:
                    best_iou, best_g = iou, g
            if best_g >= 0:
                gt_used[best_g] = True
                if not ignore[best_g]:
                    n_match += 1
            # predictions matching ignored ground truths are no false
            # positives
            if best_g >= 0 and ignore[best_g]:
                continue
            n_pred += 1
        n_gt += sum(1 for ig in ignore if not ig)
    precision = n_match / max(n_pred, 1) * 100
    recall = n_match / max(n_gt, 1) * 100
    f1 = 2 * precision * recall / max(precision + recall, 1e-4)
    return {"precision": precision, "recall": recall, "f1": f1,
            "key_metric": f1}


def evaluate_widerface_style(per_subset_results: dict,
                             iou_threshold: float = 0.5) -> dict:
    """{subset: per-image results as ``evaluate_voc_detection`` takes them}
    -> {"<subset>_ap": AP in 0..1, ..., "key_metric": their mean}."""
    out = {}
    for subset, results in per_subset_results.items():
        stats = evaluate_voc_detection(results, num_classes=1,
                                       iou_threshold=iou_threshold)
        out[f"{subset}_ap"] = stats["mAP"] / 100.0
    out["key_metric"] = float(np.mean(list(out.values())))
    return out
