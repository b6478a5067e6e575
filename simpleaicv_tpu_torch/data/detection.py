"""Detection transforms and collaters (counterpart of part of
``simpleaicv_tpu/data/detection.py``), numpy only. A sample is a dict:
'image' HWC f32, 'annots' [M, 5] as (x1, y1, x2, y2, class), 'scale' and
'size' [2]. ``DetectionResize`` and the augmentations wait for a resize
that does without cv2.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Normalize", "DETRDetectionCollater"]


class Normalize:
    """Scales the image to [0, 1] in f32."""

    def __call__(self, sample):
        sample["image"] = (sample["image"] / 255.0).astype(np.float32)
        return sample


class DETRDetectionCollater:
    """Pads images onto a square canvas of side ``resize`` (the retina style
    one of ``resize * 1333 / 800``) and annotations to ``max_annots_num``
    rows of -1, and adds the padding mask (1 = padding) and
    'scaled_annots': (cx, cy, w, h) normalised by the image's own width and
    height, and the class."""

    def __init__(self, resize=800, resize_type="yolo_style",
                 max_annots_num=100):
        if resize_type not in ("retina_style", "yolo_style"):
            raise ValueError(f"unknown resize_type {resize_type!r}")
        self.resize = resize
        if resize_type == "retina_style":
            self.resize = int(round(resize * 1333.0 / 800))
        self.max_annots_num = max_annots_num

    def __call__(self, samples):
        n, r = len(samples), self.resize
        images = np.zeros((n, r, r, 3), np.float32)
        masks = np.ones((n, r, r), np.float32)
        annots = np.full((n, self.max_annots_num, 5), -1.0, np.float32)
        scaled = np.full((n, self.max_annots_num, 5), -1.0, np.float32)
        scales = np.zeros((n,), np.float32)
        sizes = np.zeros((n, 2), np.float32)
        for i, s in enumerate(samples):
            img = s["image"]
            h, w = img.shape[:2]
            images[i, :h, :w] = img
            masks[i, :h, :w] = 0.0
            a = s["annots"]
            m = min(a.shape[0], self.max_annots_num)
            if m > 0:
                annots[i, :m] = a[:m]
                ctr = (a[:m, 0:2] + a[:m, 2:4]) / 2
                wh = a[:m, 2:4] - a[:m, 0:2]
                size_vec = np.array([w, h, w, h], np.float32)
                scaled[i, :m, :4] = np.concatenate([ctr, wh], 1) / size_vec
                scaled[i, :m, 4] = a[:m, 4]
            scales[i] = s.get("scale", 1.0)
            sizes[i] = s.get("size", img.shape[:2])
        return {"image": images, "mask": masks, "annots": annots,
                "scaled_annots": scaled, "scale": scales, "size": sizes}
