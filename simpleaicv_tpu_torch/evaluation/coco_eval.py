"""COCO-style detection mAP (a copy of
``simpleaicv_tpu/evaluation/coco_eval.py``, numpy only, so that the port
imports nothing of the JAX package): COCOeval's 'bbox' semantics (10 IoU
thresholds .5:.95, 101-point interpolated precision, the area ranges all,
small, medium and large, maxDets 100) and its 'segm' mask IoU, without
pycocotools.

Inputs are plain numpy: per-image detections (boxes xyxy, scores, classes)
and ground truths (boxes xyxy, classes). ``compute`` returns the 12
standard statistics as a dict.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _box_iou(a, b):
    """[N,4],[M,4] xyxy -> [N,M]."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    union = np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-9, None)
    return inter / union


def _mask_iou(a, b):
    """[N,H,W],[M,H,W] binary -> [N,M] mask IoU (COCOeval iouType='segm')."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    af = a.reshape(a.shape[0], -1).astype(np.float32)
    bf = b.reshape(b.shape[0], -1).astype(np.float32)
    inter = af @ bf.T
    area_a = af.sum(1)
    area_b = bf.sum(1)
    union = np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-9, None)
    return inter / union


class CocoMAPEvaluator:
    """Accumulate per-image (dets, gts); compute() returns the 12 COCO stats.

    ``iou_type='segm'`` evaluates mask mAP (reference
    tools/scripts.py:1428-1548 evaluate_coco_instance_segmentation via
    COCOeval 'segm'): pass det_masks/gt_masks ([N,H,W] binary) to add_image;
    IoU and areas come from the masks and the masks are discarded immediately
    (only the per-class IoU cache is stored)."""

    def __init__(self, num_classes: int, max_dets: int = 100,
                 iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm")
        self.num_classes = num_classes
        self.max_dets = max_dets
        self.iou_type = iou_type
        # per class: list of (scores, tp[T, D], n_gt per area)
        self._images: List[dict] = []
        self._prepared = None  # per-class grouping + IoU cache (lazy)
        self._segm_prepared: List[dict] = []

    def add_image(self, det_boxes=None, det_scores=None, det_classes=None,
                  gt_boxes=None, gt_classes=None, det_masks=None,
                  gt_masks=None, area_scale: float = 1.0):
        """area_scale multiplies mask pixel areas so small/medium/large
        buckets stay in original-image pixels when masks are evaluated at a
        reduced resolution (pass (downsample/scale)**2)."""
        det_scores = np.asarray(det_scores, np.float32)
        det_classes = np.asarray(det_classes, np.int32)
        gt_classes = np.asarray(gt_classes, np.int32)
        if self.iou_type == "segm":
            det_masks = np.asarray(det_masks) > 0.5
            gt_masks = np.asarray(gt_masks) > 0.5
            if det_masks.ndim == 2:  # no dets: allow [0, ...] shapes
                det_masks = det_masks.reshape((0,) + gt_masks.shape[1:]) \
                    if gt_masks.ndim == 3 else det_masks[None][:0]
            per_class = {}
            classes = np.unique(np.concatenate([det_classes, gt_classes]))
            for k in classes.tolist():
                dm = det_masks[det_classes == k]
                scores = det_scores[det_classes == k]
                gm = gt_masks[gt_classes == k]
                order = np.argsort(-scores, kind="stable")[:self.max_dets]
                dm, scores = dm[order], scores[order]
                def _areas(m):
                    if m.shape[0] == 0:
                        return np.zeros((0,), np.float32)
                    return m.reshape(m.shape[0], -1).sum(1).astype(
                        np.float32) * area_scale
                per_class[k] = dict(scores=scores, ious=_mask_iou(dm, gm),
                                    det_area=_areas(dm), gt_area=_areas(gm))
            self._segm_prepared.append(per_class)
            return
        self._images.append(dict(
            det_boxes=np.asarray(det_boxes, np.float32),
            det_scores=det_scores,
            det_classes=det_classes,
            gt_boxes=np.asarray(gt_boxes, np.float32),
            gt_classes=gt_classes,
        ))
        self._prepared = None

    def _prepare(self):
        """Group dets/gts by class once per image, pre-sort dets by score,
        and cache the IoU matrix + box areas (shared by all 4 area ranges —
        COCOeval computes ious once per (img, cat) the same way)."""
        prepared = []
        for img in self._images:
            per_class = {}
            classes = np.unique(np.concatenate(
                [img["det_classes"], img["gt_classes"]]))
            for k in classes.tolist():
                dets = img["det_boxes"][img["det_classes"] == k]
                scores = img["det_scores"][img["det_classes"] == k]
                gts = img["gt_boxes"][img["gt_classes"] == k]
                order = np.argsort(-scores, kind="stable")[:self.max_dets]
                dets, scores = dets[order], scores[order]
                per_class[k] = dict(
                    dets=dets, scores=scores, gts=gts,
                    ious=_box_iou(dets, gts),
                    det_area=np.clip(dets[:, 2] - dets[:, 0], 0, None) *
                    np.clip(dets[:, 3] - dets[:, 1], 0, None),
                    gt_area=np.clip(gts[:, 2] - gts[:, 0], 0, None) *
                    np.clip(gts[:, 3] - gts[:, 1], 0, None))
            prepared.append(per_class)
        self._prepared = prepared

    def _match_one(self, dets, det_scores, gts, area_rng):
        """Greedy matching per COCOeval. Returns (tp [T,D], det_ignore [T,D],
        sorted scores, non-ignored gt count)."""
        order = np.argsort(-det_scores, kind="stable")[:self.max_dets]
        dets, scores = dets[order], det_scores[order]
        entry = dict(
            dets=dets, scores=scores, gts=gts, ious=_box_iou(dets, gts),
            det_area=np.clip(dets[:, 2] - dets[:, 0], 0, None) *
            np.clip(dets[:, 3] - dets[:, 1], 0, None),
            gt_area=np.clip(gts[:, 2] - gts[:, 0], 0, None) *
            np.clip(gts[:, 3] - gts[:, 1], 0, None))
        return self._match_prepared(entry, area_rng)

    def _match_prepared(self, entry, area_rng):
        """Core greedy matching on a cached (class, image) entry."""
        T = len(IOU_THRS)
        gt_ignore = ((entry["gt_area"] < area_rng[0]) |
                     (entry["gt_area"] > area_rng[1]))
        # sort gts: non-ignored first (COCOeval sorts by ignore flag)
        gt_order = np.argsort(gt_ignore, kind="stable")
        gt_ignore = gt_ignore[gt_order]
        ious = entry["ious"][:, gt_order]
        D, G = ious.shape

        tp = np.zeros((T, D), bool)
        det_ig = np.zeros((T, D), bool)
        if G > 0:
            thr_eff = np.minimum(IOU_THRS, 1 - 1e-10)[:, None]  # [T,1]
            gt_matched = np.zeros((T, G), bool)
            t_idx = np.arange(T)
            for d in range(D):
                # all thresholds at once: among unmatched gts above each
                # threshold, prefer non-ignored (COCOeval's ignore-sorted
                # scan); pick the highest-IoU gt in the pool
                cand = (~gt_matched) & (ious[d][None, :] >= thr_eff)  # [T,G]
                non_ig = cand & ~gt_ignore[None, :]
                use_non_ig = non_ig.any(1, keepdims=True)
                pool = np.where(use_non_ig, non_ig, cand)
                has = pool.any(1)
                if not has.any():
                    continue
                best_g = np.argmax(np.where(pool, ious[d][None, :], -1.0), 1)
                rows = t_idx[has]
                picked = best_g[has]
                gt_matched[rows, picked] = True
                picked_ig = gt_ignore[picked]
                det_ig[rows, d] = picked_ig
                tp[rows, d] = ~picked_ig
        # unmatched dets outside the area range are ignored
        out_of_range = ((entry["det_area"] < area_rng[0]) |
                        (entry["det_area"] > area_rng[1]))
        det_ig |= (~tp) & out_of_range[None, :]
        n_gt = int((~gt_ignore).sum())
        return tp, det_ig, entry["scores"], n_gt

    def _accumulate(self, area_name):
        """-> precision [T, R, K], recall [T, K]."""
        area_rng = AREA_RANGES[area_name]
        T, R, K = len(IOU_THRS), len(RECALL_THRS), self.num_classes
        precision = -np.ones((T, R, K))
        recall = -np.ones((T, K))

        if self.iou_type == "segm":
            prepared = self._segm_prepared
        else:
            if self._prepared is None:
                self._prepare()
            prepared = self._prepared
        # invert image-major cache to class-major
        by_class: Dict[int, list] = {}
        for per_class in prepared:
            for k, entry in per_class.items():
                by_class.setdefault(k, []).append(entry)

        for k in range(K):
            all_tp, all_ig, all_scores = [], [], []
            total_gt = 0
            for entry in by_class.get(k, ()):
                tp, det_ig, scores, n_gt = self._match_prepared(
                    entry, area_rng)
                all_tp.append(tp)
                all_ig.append(det_ig)
                all_scores.append(scores)
                total_gt += n_gt
            if not all_scores or total_gt == 0:
                continue
            scores = np.concatenate(all_scores)
            order = np.argsort(-scores, kind="mergesort")
            tp = np.concatenate(all_tp, axis=1)[:, order]
            ig = np.concatenate(all_ig, axis=1)[:, order]

            for t in range(T):
                keep = ~ig[t]
                tps = np.cumsum(tp[t][keep])
                fps = np.cumsum((~tp[t][keep]))
                rc = tps / total_gt
                pr = tps / np.clip(tps + fps, 1e-9, None)
                recall[t, k] = rc[-1] if rc.size else 0.0
                # make precision monotonically decreasing
                pr = np.maximum.accumulate(pr[::-1])[::-1] if pr.size else pr
                # 101-point interpolation
                inds = np.searchsorted(rc, RECALL_THRS, side="left")
                q = np.zeros(R)
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[t, :, k] = q
        return precision, recall

    def compute(self) -> Dict[str, float]:
        stats = {}
        p_all, r_all = self._accumulate("all")

        def mean_valid(x):
            v = x[x > -1]
            return float(v.mean()) if v.size else -1.0

        stats["IoU=0.5:0.95,area=all,maxDets=100,mAP"] = mean_valid(p_all)
        stats["IoU=0.5,area=all,maxDets=100,mAP"] = mean_valid(p_all[0])
        stats["IoU=0.75,area=all,maxDets=100,mAP"] = mean_valid(p_all[5])
        stats["IoU=0.5:0.95,area=all,maxDets=100,mAR"] = mean_valid(r_all)
        for area in ("small", "medium", "large"):
            p, r = self._accumulate(area)
            stats[f"IoU=0.5:0.95,area={area},maxDets=100,mAP"] = mean_valid(p)
            stats[f"IoU=0.5:0.95,area={area},maxDets=100,mAR"] = mean_valid(r)
        return stats


def evaluate_coco_detection_map(per_image_results: Sequence[dict],
                                num_classes: int) -> Dict[str, float]:
    """per_image_results: iterable of dicts with det_boxes/det_scores/
    det_classes/gt_boxes/gt_classes."""
    ev = CocoMAPEvaluator(num_classes)
    for r in per_image_results:
        ev.add_image(**r)
    return ev.compute()
