"""YOLOv3 anchor k-means (counterpart of
``simpleaicv_tpu/data/yolov3_anchor_cluster.py``): IoU-distance k-means
over a dataset's box shapes, in numpy on the host."""

from __future__ import annotations

import numpy as np

__all__ = ["iou_wh", "kmeans_anchors"]


def iou_wh(wh, anchors):
    """[N, 2] box sizes against [K, 2] anchors -> [N, K] IoU of co-centred
    boxes."""
    inter = np.minimum(wh[:, None, 0], anchors[None, :, 0]) * \
        np.minimum(wh[:, None, 1], anchors[None, :, 1])
    union = wh[:, 0:1] * wh[:, 1:2] + \
        (anchors[:, 0] * anchors[:, 1])[None] - inter
    return inter / np.clip(union, 1e-10, None)


def kmeans_anchors(boxes_wh: np.ndarray, k: int = 9, iters: int = 300,
                   seed: int = 0):
    """(anchors [k, 2] sorted by area, mean best IoU): k-means with the
    distance 1 - IoU, started from k boxes drawn by
    ``np.random.RandomState(seed)``, each centre moved to its members'
    median, stopping when no box changes cluster."""
    rng = np.random.RandomState(seed)
    wh = np.asarray(boxes_wh, np.float64)
    anchors = wh[rng.choice(len(wh), k, replace=False)]
    last = None
    for _ in range(iters):
        assign = (1.0 - iou_wh(wh, anchors)).argmin(1)
        if last is not None and (assign == last).all():
            break
        for i in range(k):
            members = wh[assign == i]
            if len(members):
                anchors[i] = np.median(members, axis=0)
        last = assign
    anchors = anchors[np.argsort(anchors[:, 0] * anchors[:, 1])]
    return anchors, float(iou_wh(wh, anchors).max(1).mean())
