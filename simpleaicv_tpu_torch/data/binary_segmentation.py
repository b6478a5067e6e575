"""Binary-segmentation (salient-object detection) data pipeline
(counterpart of ``simpleaicv_tpu/data/binary_segmentation.py``), without
OpenCV: a keep-ratio resize (the image by ``F.interpolate`` at pixel
centres, the mask by nearest neighbour, as in ``data.segmentation``), a
flip drawn from ``numpy.random`` as the JAX package draws it, /255 and a
collater onto zero-padded square canvases.
"""

from __future__ import annotations

import numpy as np

from .interactive_segmentation import resize_nearest
from .transforms import resize_bilinear

__all__ = ["BinarySegResize", "BinarySegRandomHorizontalFlip",
           "BinarySegNormalize", "BinarySegCollater"]


class BinarySegResize:
    """Keep-ratio resize so that the long side is ``resize``."""

    def __init__(self, resize=832):
        self.resize = resize

    def __call__(self, sample):
        h, w = sample["image"].shape[:2]
        factor = self.resize / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        sample["image"] = resize_bilinear(sample["image"], nh, nw)
        sample["mask"] = resize_nearest(sample["mask"], nh, nw)
        sample["size"] = np.array([nh, nw], np.float32)
        sample["scale"] = np.float32(sample.get("scale", 1.0) * factor)
        return sample


class BinarySegRandomHorizontalFlip:

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if np.random.uniform(0, 1) < self.prob:
            sample["image"] = sample["image"][:, ::-1].copy()
            sample["mask"] = sample["mask"][:, ::-1].copy()
        return sample


class BinarySegNormalize:

    def __call__(self, sample):
        sample["image"] = sample["image"] / 255.0
        return sample


class BinarySegCollater:
    """-> image [B, S, S, 3] f32 and mask [B, S, S] f32 on zero-padded
    canvases."""

    def __init__(self, resize=832):
        self.resize = resize

    def __call__(self, samples):
        b, s = len(samples), self.resize
        images = np.zeros((b, s, s, 3), np.float32)
        masks = np.zeros((b, s, s), np.float32)
        for i, smp in enumerate(samples):
            img = smp["image"]
            h, w = img.shape[:2]
            images[i, :h, :w] = img
            masks[i, :h, :w] = smp["mask"]
        return {"image": images, "mask": masks}
