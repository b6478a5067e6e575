"""Mosaic detection augmentation (counterpart of
``simpleaicv_tpu/data/mosaic.py``): with probability ``mosaic_prob`` four
samples are resized into the quadrants of a 2r x 2r canvas around a random
centre, their boxes moved with them, and the canvas resized back to r x r;
boxes narrower or lower than 2 pixels after that are dropped.

The JAX transform draws from Python's global ``random``; this one draws
from the ``random.Random`` it is given (seed 0 without one), in the same
order, so that the two choose alike when seeded alike. OpenCV's bilinear
resize is ``data/transforms.py::resize_bilinear`` (no antialiasing)."""

from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np

from .transforms import resize_bilinear

__all__ = ["MosaicResizeDetection"]


class MosaicResizeDetection:
    """Wraps a detection dataset whose samples hold 'image' [h, w, 3] and
    'annots' [n, 5] (x1, y1, x2, y2, class) with mosaic mixing."""

    def __init__(self, dataset, resize: int = 640, mosaic_prob: float = 0.5,
                 transform: Optional[Callable] = None,
                 rng: random.Random | None = None):
        self.dataset = dataset
        self.resize = resize
        self.mosaic_prob = mosaic_prob
        self.transform = transform
        self.rng = rng if rng is not None else random.Random(0)

    def __len__(self):
        return len(self.dataset)

    def _mosaic(self, idx):
        r, rng = self.resize, self.rng
        canvas = np.zeros((2 * r, 2 * r, 3), np.float32)
        cx = int(rng.uniform(0.5 * r, 1.5 * r))
        cy = int(rng.uniform(0.5 * r, 1.5 * r))
        idxs = [idx] + [rng.randint(0, len(self.dataset) - 1)
                        for _ in range(3)]
        corners = [(0, 0, cx, cy), (cx, 0, 2 * r, cy),
                   (0, cy, cx, 2 * r), (cx, cy, 2 * r, 2 * r)]
        all_annots = []
        for i, (x1, y1, x2, y2) in zip(idxs, corners):
            sample = self.dataset[i]
            img, ann = sample["image"], sample["annots"]
            tw, th = x2 - x1, y2 - y1
            if tw < 2 or th < 2:
                continue
            h, w = img.shape[:2]
            canvas[y1:y2, x1:x2] = resize_bilinear(img, th, tw)
            if ann.shape[0] > 0:
                a = ann.copy()
                a[:, [0, 2]] = a[:, [0, 2]] * (tw / w) + x1
                a[:, [1, 3]] = a[:, [1, 3]] * (th / h) + y1
                all_annots.append(a)
        annots = (np.concatenate(all_annots, 0) if all_annots
                  else np.zeros((0, 5), np.float32))
        canvas = resize_bilinear(canvas, r, r)
        if annots.shape[0] > 0:
            annots[:, :4] *= 0.5
            keep = (((annots[:, 2] - annots[:, 0]) > 2)
                    & ((annots[:, 3] - annots[:, 1]) > 2))
            annots = annots[keep]
        return {"image": canvas, "annots": annots, "scale": np.float32(1.0),
                "size": np.array([r, r], np.float32)}

    def __getitem__(self, idx):
        if self.rng.random() >= self.mosaic_prob:
            sample = self.dataset[idx]
        else:
            sample = self._mosaic(idx)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
