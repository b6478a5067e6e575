"""Classification collater (counterpart of
``simpleaicv_tpu/data/collater.py``): stacks samples into NHWC numpy
batches, the layout the port's models take."""

from __future__ import annotations

import numpy as np

__all__ = ["ClassificationCollater"]


class ClassificationCollater:
    """{"image": [B, H, W, 3] in ``image_dtype``, "label": [B] int32}.
    ``image_dtype="uint8"`` ships raw 0..255 batches at a quarter of the
    f32 bytes."""

    def __init__(self, image_dtype=np.float32):
        self.image_dtype = np.dtype(image_dtype)

    def __call__(self, samples):
        images = np.stack([s["image"] for s in samples]).astype(
            self.image_dtype)
        labels = np.asarray([s["label"] for s in samples], np.int32)
        return {"image": images, "label": labels}
