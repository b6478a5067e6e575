"""ADE20K semantic-segmentation reader (counterpart of
``simpleaicv_tpu/data/datasets/ade20k.py``): ``<root>/images/<set>/`` and
same-stem ``<root>/annotations/<set>/*.png`` label maps, read grey as
OpenCV's ``IMREAD_GRAYSCALE`` reads them (``data/image_io.py``); with
``reduce_zero_label`` label 0 becomes ``ignore_index`` and the 150 classes
0..149."""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..image_io import read_grey, read_image

__all__ = ["ADE20KDataset"]


class ADE20KDataset:
    """Samples {"image": [h, w, 3] f32, "mask": [h, w] int32, "scale",
    "size"}."""

    def __init__(self, root_dir: str, image_sets: str = "training",
                 reduce_zero_label: bool = True, ignore_index: int = 255,
                 transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.image_sets = image_sets
        self.reduce_zero_label = reduce_zero_label
        self.ignore_index = ignore_index
        self.transform = transform
        self._items = None

    def _scan(self):
        if self._items is not None:
            return
        img_dir = os.path.join(self.root_dir, "images", self.image_sets)
        ann_dir = os.path.join(self.root_dir, "annotations", self.image_sets)
        items = []
        for fname in sorted(os.listdir(img_dir)):
            mask_path = os.path.join(ann_dir,
                                     os.path.splitext(fname)[0] + ".png")
            if os.path.exists(mask_path):
                items.append((os.path.join(img_dir, fname), mask_path))
        self._items = items

    def __len__(self):
        self._scan()
        return len(self._items)

    def __getitem__(self, idx):
        self._scan()
        img_path, mask_path = self._items[idx]
        image = read_image(img_path)
        mask = read_grey(mask_path).astype(np.int32)
        if self.reduce_zero_label:
            mask = mask - 1
            mask[mask < 0] = self.ignore_index
        sample = {"image": image.astype(np.float32), "mask": mask,
                  "scale": np.float32(1.0),
                  "size": np.array(image.shape[:2], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
