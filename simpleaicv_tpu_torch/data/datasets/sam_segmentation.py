"""SA-1B interactive-segmentation reader (counterpart of
``simpleaicv_tpu/data/datasets/sam_segmentation.py``): images under
``<root>/<set_name>/<set_type>/`` (or ``<root>/<set_name>/`` where that
folder is absent), each with a same-stem ``.json`` of {"annotations":
[{"segmentation": polygons or an RLE, uncompressed or compressed as real
SA-1B writes it, "area", ...}]}; one object mask a sample.

Departs from the JAX reader in one place: it picks a random mask with
Python's global ``random.choice``, the port with the ``random.Random``
it is given (``rng``; its own from seed 0 without one). A ``Random``
seeded as the global state was gives the same choices.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Optional, Sequence

import numpy as np

from ..image_io import read_image
from .coco_instance import segmentation_to_mask

__all__ = ["SAMSegmentationDataset"]


class SAMSegmentationDataset:
    """Samples {"image": [h, w, 3] f32 0..255 RGB, "mask": [h, w] f32 0/1}:
    a random annotation's mask (``per_image_mask_chosen="random"``) or
    the largest by ``area``; an image with no annotation gives an empty
    mask."""

    def __init__(self, root_dir: str,
                 set_name_list: Sequence[str] = ("sa_000000",),
                 set_type: str = "train",
                 per_image_mask_chosen: str = "random",
                 transform: Optional[Callable] = None,
                 rng: Optional[random.Random] = None):
        self.root_dir = root_dir
        self.set_name_list = list(set_name_list)
        self.set_type = set_type
        self.per_image_mask_chosen = per_image_mask_chosen
        self.transform = transform
        self.rng = rng if rng is not None else random.Random(0)
        self._items = None

    def _scan(self):
        if self._items is not None:
            return
        items = []
        for set_name in self.set_name_list:
            d = os.path.join(self.root_dir, set_name)
            if self.set_type and os.path.isdir(os.path.join(d,
                                                            self.set_type)):
                d = os.path.join(d, self.set_type)
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png")):
                    jpath = os.path.join(d, os.path.splitext(fname)[0]
                                         + ".json")
                    if os.path.exists(jpath):
                        items.append((os.path.join(d, fname), jpath))
        self._items = items

    def __len__(self):
        self._scan()
        return len(self._items)

    def __getitem__(self, idx):
        self._scan()
        img_path, json_path = self._items[idx]
        image = read_image(img_path).astype(np.float32)
        h, w = image.shape[:2]
        with open(json_path, encoding="utf-8") as f:
            annots = json.load(f).get("annotations", [])
        if annots:
            if self.per_image_mask_chosen == "random":
                chosen = self.rng.choice(annots)
            else:
                chosen = max(annots, key=lambda a: a.get("area", 0))
            mask = segmentation_to_mask(chosen.get("segmentation", []), h, w)
        else:
            mask = np.zeros((h, w), np.uint8)
        sample = {"image": image, "mask": mask.astype(np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
