"""OCR readers (counterpart of ``simpleaicv_tpu/data/datasets/text.py``):
image folders ``<root>/<set_name>/<set_type>/`` with a label file
``<root>/<set_name>/<set_name>_<set_type>.json`` each, combined over
``set_name_list``; the keys in sorted order, those whose image exists.

* ``TextDetection``: {file: {"shapes": [{"points": [[x, y], ...],
  "label", "ignore"}, ...]}} (or the list of shapes itself); polygons of
  fewer than 3 points dropped, "###" and "*" labels ignored.
* ``TextRecognition``: {file: text} (or {file: {"label": text}}).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np

from ..image_io import read_image

__all__ = ["TextDetection", "TextRecognition"]


class _LabelledFolders:

    def __init__(self, root_dir: str, set_name_list: Sequence[str],
                 set_type: str = "train",
                 transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.set_name_list = list(set_name_list)
        self.set_type = set_type
        self.transform = transform
        self._items = None

    @staticmethod
    def _label(ann):
        return ann

    def _scan(self):
        if self._items is not None:
            return
        items = []
        for set_name in self.set_name_list:
            img_dir = os.path.join(self.root_dir, set_name, self.set_type)
            label_path = os.path.join(self.root_dir, set_name,
                                      f"{set_name}_{self.set_type}.json")
            if not (os.path.isdir(img_dir) and os.path.exists(label_path)):
                continue
            with open(label_path, encoding="utf-8") as f:
                labels = json.load(f)
            for key, ann in sorted(labels.items()):
                path = os.path.join(img_dir, key)
                if os.path.exists(path):
                    items.append((path, self._label(ann)))
        self._items = items

    def __len__(self):
        self._scan()
        return len(self._items)

    def _load(self, idx):
        self._scan()
        path, ann = self._items[idx]
        return read_image(path).astype(np.float32), ann

    def _out(self, sample):
        return self.transform(sample) if self.transform is not None \
            else sample


class TextDetection(_LabelledFolders):
    """Samples {"image": [h, w, 3] f32, "annots": list of [k, 2] f32
    polygons, "ignore_flags": list of bool}."""

    def __getitem__(self, idx):
        image, ann = self._load(idx)
        polys, ignores = [], []
        shapes = ann.get("shapes", ann) if isinstance(ann, dict) else ann
        for shape in shapes:
            pts = np.asarray(shape.get("points", shape.get("box", [])),
                             np.float32)
            if pts.size < 6:
                continue
            polys.append(pts.reshape(-1, 2))
            ignores.append(shape.get("label", "") in ("###", "*")
                           or shape.get("ignore", False))
        return self._out({"image": image, "annots": polys,
                          "ignore_flags": ignores})


class TextRecognition(_LabelledFolders):
    """Samples {"image": [h, w, 3] f32, "label": the text}."""

    @staticmethod
    def _label(ann):
        return ann.get("label", "") if isinstance(ann, dict) else ann

    def __getitem__(self, idx):
        image, text = self._load(idx)
        return self._out({"image": image, "label": text})
