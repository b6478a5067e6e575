"""COCO semantic-segmentation reader (counterpart of
``simpleaicv_tpu/data/datasets/coco_semantic.py``): one category map per
image, painted instance by instance (a later instance overwrites an
earlier one) with labels 1..80 over background 0; ``reduce_zero_label``
maps the background to 255 and the classes to 0..79."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .coco import CocoDetection
from .coco_instance import segmentation_to_mask

__all__ = ["CocoSemanticSegmentation"]


class CocoSemanticSegmentation(CocoDetection):
    """Samples {"image", "mask": [h, w] int32, "scale", "size"}."""

    def __init__(self, root_dir: str, set_name: str = "train2017",
                 transform: Optional[Callable] = None,
                 reduce_zero_label: bool = False):
        super().__init__(root_dir, set_name, transform=transform)
        self.reduce_zero_label = reduce_zero_label

    def __getitem__(self, idx):
        self._load()
        image_id = self.image_ids[idx]
        image = self.load_image(image_id)
        h, w = image.shape[:2]
        mask = np.zeros((h, w), np.float64)
        for a in self.anns_by_image.get(image_id, []):
            if "ignore" in a:
                continue
            binary = segmentation_to_mask(a.get("segmentation", []), h, w)
            label = self.cat_id_to_label[a["category_id"]] + 1
            mask = mask * (1 - binary) + binary * label
        mask = mask.astype(np.int32)
        if self.reduce_zero_label:
            mask[mask == 0] = 256
            mask = mask - 1
        sample = {"image": image, "mask": mask, "scale": np.float32(1.0),
                  "size": np.array([h, w], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
