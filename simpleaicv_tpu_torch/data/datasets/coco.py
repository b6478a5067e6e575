"""Synthetic detection data (counterpart of
``simpleaicv_tpu/data/datasets/coco.py::FakeDetectionDataset``). The COCO
reader waits for an image decoder that does without cv2."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["FakeDetectionDataset"]


class FakeDetectionDataset:
    """Coloured rectangles on noise, the class given by the colour. Sample
    ``idx`` is drawn from ``np.random.RandomState(idx)``: 1 to ``max_boxes``
    boxes of sides hw/8 to hw/2 on an ``image_hw`` square."""

    def __init__(self, num_samples=64, image_hw=256, num_classes=8,
                 max_boxes=4, transform: Optional[Callable] = None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        hw = self.image_hw
        image = rng.uniform(0, 60, (hw, hw, 3)).astype(np.float32)
        annots = []
        for _ in range(rng.randint(1, self.max_boxes + 1)):
            w = rng.randint(hw // 8, hw // 2)
            h = rng.randint(hw // 8, hw // 2)
            x1 = rng.randint(0, hw - w)
            y1 = rng.randint(0, hw - h)
            cls = rng.randint(0, self.num_classes)
            color = np.zeros(3, np.float32)
            color[cls % 3] = 200.0 + 55.0 * (cls // 3) / max(
                self.num_classes // 3, 1)
            image[y1:y1 + h, x1:x1 + w] = color
            annots.append([x1, y1, x1 + w, y1 + h, cls])
        sample = {"image": image,
                  "annots": np.asarray(annots, np.float32),
                  "scale": np.float32(1.0),
                  "size": np.array([hw, hw], np.float32),
                  "image_id": idx}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
