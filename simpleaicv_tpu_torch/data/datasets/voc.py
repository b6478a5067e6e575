"""Pascal VOC detection reader and VOC AP (counterpart of
``simpleaicv_tpu/data/datasets/voc.py``): ``<root>/VOC<year>/`` with
``ImageSets/Main/<split>.txt``, ``Annotations/<id>.xml`` and
``JPEGImages/<id>.jpg``; the 20 classes, ``difficult`` objects dropped
unless kept, xmin and ymin moved by -1. ``compute_voc_ap`` (the 11-point
form of VOC2007 or the area under the interpolated curve) and
``evaluate_voc_detection`` (greedy matching by score at IoU 0.5)."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..image_io import read_image

__all__ = ["VOC_CLASSES", "VocDetection", "compute_voc_ap",
           "evaluate_voc_detection"]

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class VocDetection:
    """Samples {"image": [h, w, 3] f32 0..255 RGB, "annots": [n, 5] f32,
    "scale": 1, "size": [h, w]}."""

    def __init__(self, root_dir: str,
                 image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"),
                                                          ("2012", "trainval")),
                 transform: Optional[Callable] = None,
                 keep_difficult: bool = False):
        self.root_dir = root_dir
        self.image_sets = image_sets
        self.transform = transform
        self.keep_difficult = keep_difficult
        self.class_to_idx = {c: i for i, c in enumerate(VOC_CLASSES)}
        self._ids = None

    def _scan(self):
        if self._ids is not None:
            return
        ids = []
        for year, split in self.image_sets:
            root = os.path.join(self.root_dir, f"VOC{year}")
            with open(os.path.join(root, "ImageSets", "Main",
                                   f"{split}.txt")) as f:
                ids.extend((root, line.strip()) for line in f)
        self._ids = ids

    def __len__(self):
        self._scan()
        return len(self._ids)

    def load_annots(self, idx) -> np.ndarray:
        root, name = self._ids[idx]
        tree = ET.parse(os.path.join(root, "Annotations", f"{name}.xml"))
        out = []
        for obj in tree.getroot().iter("object"):
            if int(obj.find("difficult").text) == 1 and \
                    not self.keep_difficult:
                continue
            cls = obj.find("name").text.lower().strip()
            bbox = obj.find("bndbox")
            coords = [float(bbox.find(t).text) - (1 if t in ("xmin", "ymin")
                                                  else 0)
                      for t in ("xmin", "ymin", "xmax", "ymax")]
            out.append(coords + [self.class_to_idx[cls]])
        if not out:
            return np.zeros((0, 5), np.float32)
        return np.asarray(out, np.float32)

    def __getitem__(self, idx):
        self._scan()
        root, name = self._ids[idx]
        image = read_image(os.path.join(root, "JPEGImages",
                                        f"{name}.jpg")).astype(np.float32)
        sample = {"image": image, "annots": self.load_annots(idx),
                  "scale": np.float32(1.0),
                  "size": np.array(image.shape[:2], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


def compute_voc_ap(recall, precision, use_07_metric=False):
    """AP of a precision-recall curve: VOC2007's mean of the best precision
    at recall 0, 0.1, ..., 1, or the area under the curve made monotone."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _match_image(dets, dscores, gts, iou_threshold):
    """Each detection, best score first, takes the unmatched ground truth
    of the highest IoU at or above the threshold (the last of a tie);
    (score, is a true positive) per detection in that order."""
    matched = np.zeros(len(gts), bool)
    out = []
    for d in np.argsort(-dscores):
        box = dets[d]
        best_iou, best_g = iou_threshold, -1
        for g in range(len(gts)):
            if matched[g]:
                continue
            lt = np.maximum(box[:2], gts[g][:2])
            rb = np.minimum(box[2:], gts[g][2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[0] * wh[1]
            a1 = max((box[2] - box[0]) * (box[3] - box[1]), 0)
            a2 = max((gts[g][2] - gts[g][0]) * (gts[g][3] - gts[g][1]), 0)
            iou = inter / max(a1 + a2 - inter, 1e-8)
            if iou >= best_iou:
                best_iou, best_g = iou, g
        if best_g >= 0:
            matched[best_g] = True
        out.append((dscores[d], best_g >= 0))
    return out


def evaluate_voc_detection(per_image_results, num_classes: int,
                           iou_threshold: float = 0.5,
                           use_07_metric: bool = False) -> dict:
    """``per_image_results``: dicts of det_boxes, det_scores, det_classes,
    gt_boxes and gt_classes. Per-class AP over the classes that have a
    ground truth, and their mean in percent (``mAP``, ``key_metric``)."""
    aps = {}
    for c in range(num_classes):
        scored, n_gt = [], 0
        for r in per_image_results:
            det_m = np.asarray(r["det_classes"]) == c
            gts = np.asarray(r["gt_boxes"], np.float32)[
                np.asarray(r["gt_classes"]) == c]
            n_gt += len(gts)
            scored += _match_image(
                np.asarray(r["det_boxes"], np.float32)[det_m],
                np.asarray(r["det_scores"], np.float32)[det_m], gts,
                iou_threshold)
        if n_gt == 0:
            continue
        scores = np.asarray([s for s, _ in scored])
        tps = np.asarray([float(t) for _, t in scored])
        order = np.argsort(-scores)
        tp = np.cumsum(tps[order])
        fp = np.cumsum(1.0 - tps[order])
        recall = tp / n_gt
        precision = tp / np.clip(tp + fp, 1e-8, None)
        aps[c] = compute_voc_ap(recall, precision, use_07_metric)
    mAP = float(np.mean(list(aps.values()))) * 100 if aps else 0.0
    return {"per_class_ap": aps, "mAP": mAP, "key_metric": mAP}
