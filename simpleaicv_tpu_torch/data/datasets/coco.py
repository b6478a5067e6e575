"""COCO detection reader and synthetic detection data (counterpart of
``simpleaicv_tpu/data/datasets/coco.py``).

``CocoDetection`` parses ``<root>/annotations/instances_<set>.json``
itself (no pycocotools): crowd annotations dropped, boxes with a side
under 1 or no area dropped, the categories sorted by id onto the
contiguous labels 0..79 (``label_to_cat_id`` maps them back), images read
from ``<root>/images/<set>/`` or else ``<root>/<set>/`` through
``data/image_io.py`` (OpenCV's pixels without OpenCV).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

from ..image_io import read_image

__all__ = ["CocoDetection", "FakeDetectionDataset", "COCO_CLASSES_NUM"]

COCO_CLASSES_NUM = 80


class CocoDetection:
    """Samples {"image": [h, w, 3] f32 0..255 RGB, "annots": [n, 5] f32
    x1, y1, x2, y2, label, "scale": 1, "size": [h, w], "image_id"}."""

    def __init__(self, root_dir: str, set_name: str = "train2017",
                 transform: Optional[Callable] = None,
                 filter_no_object_image: bool = False):
        self.root_dir = root_dir
        self.set_name = set_name
        self.transform = transform
        self.filter_no_object_image = filter_no_object_image
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        ann_path = os.path.join(self.root_dir, "annotations",
                                f"instances_{self.set_name}.json")
        with open(ann_path) as f:
            data = json.load(f)

        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.cat_id_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.label_to_cat_id = {i: c["id"] for i, c in enumerate(cats)}
        self.class_names = [c["name"] for c in cats]

        self.images = {im["id"]: im for im in data["images"]}
        anns_by_image: dict = {}
        for a in data["annotations"]:
            if not a.get("iscrowd", 0):
                anns_by_image.setdefault(a["image_id"], []).append(a)
        image_ids = sorted(self.images)
        if self.filter_no_object_image:
            image_ids = [i for i in image_ids if anns_by_image.get(i)]
        self.image_ids = image_ids
        self.anns_by_image = anns_by_image
        self._loaded = True

    def __len__(self):
        self._load()
        return len(self.image_ids)

    def load_annots(self, image_id) -> np.ndarray:
        out = []
        for a in self.anns_by_image.get(image_id, []):
            x, y, w, h = a["bbox"]
            if w < 1 or h < 1 or a.get("area", w * h) <= 0:
                continue
            out.append([x, y, x + w, y + h,
                        self.cat_id_to_label[a["category_id"]]])
        if not out:
            return np.zeros((0, 5), np.float32)
        return np.asarray(out, np.float32)

    def image_path(self, image_id) -> str:
        name = self.images[image_id]["file_name"]
        path = os.path.join(self.root_dir, "images", self.set_name, name)
        if not os.path.exists(path):
            path = os.path.join(self.root_dir, self.set_name, name)
        return path

    def load_image(self, image_id) -> np.ndarray:
        return read_image(self.image_path(image_id)).astype(np.float32)

    def __getitem__(self, idx):
        self._load()
        image_id = self.image_ids[idx]
        image = self.load_image(image_id)
        sample = {"image": image, "annots": self.load_annots(image_id),
                  "scale": np.float32(1.0),
                  "size": np.array(image.shape[:2], np.float32),
                  "image_id": image_id}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


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
