"""Folder readers of salient-object detection, human matting, human and
face parsing and face detection (counterpart of
``simpleaicv_tpu/data/datasets/combined_folder.py``), over
``<root>/<set_name>/<set_type>/`` layouts combined across
``set_name_list``:

* ``SalientObjectDetectionDataset``, ``HumanMattingDataset``,
  ``HumanParsingDataset`` and ``FaceParsingDataset``: a ``.jpg``/``.jpeg``
  image and a same-stem ``.png`` mask in one folder; the mask read grey as
  OpenCV's ``IMREAD_GRAYSCALE`` reads it (``data/image_io.py``);
* ``FaceDetectionDataset``: ``<root>/<set_name>/images/<set_type>/`` and
  ``<root>/<set_name>/annotations/<set_name>_<set_type>.json`` with
  {file name: {"face_box": [[x1, y1, x2, y2], ...]}}.

The matting trimap erodes the sure foreground and dilates the alpha's
support by an elliptic element with ``data/raster.py``'s ``erode`` and
``dilate`` (OpenCV's, equal on 0/1 masks).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np

from ..image_io import read_grey, read_image
from ..raster import dilate, ellipse_element, erode

__all__ = ["SalientObjectDetectionDataset", "HumanMattingDataset",
           "HumanParsingDataset", "FaceParsingDataset",
           "FaceDetectionDataset"]


def _sample(image, **fields):
    return {"image": image, **fields, "scale": np.float32(1.0),
            "size": np.array(image.shape[:2], np.float32)}


class _PairFolderBase:
    """``<root>/<set_name>/<set_type>/`` holding images and same-stem
    ``.png`` masks; stems sorted within each set."""

    def __init__(self, root_dir: str, set_name_list: Sequence[str],
                 set_type: str = "train",
                 transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.set_name_list = list(set_name_list)
        self.set_type = set_type
        self.transform = transform
        self._items = None

    def _scan(self):
        if self._items is not None:
            return
        items = []
        for set_name in self.set_name_list:
            d = os.path.join(self.root_dir, set_name, self.set_type)
            if not os.path.isdir(d):
                continue
            stems = {}
            for f in sorted(os.listdir(d)):
                stem, ext = os.path.splitext(f)
                stems.setdefault(stem, {})[ext.lower()] = os.path.join(d, f)
            for stem, exts in sorted(stems.items()):
                img = next((exts[e] for e in (".jpg", ".jpeg") if e in exts),
                           None)
                mask = exts.get(".png")
                if img and mask:
                    items.append((img, mask))
        self._items = items

    def __len__(self):
        self._scan()
        return len(self._items)

    def _load_pair(self, idx):
        self._scan()
        img_path, mask_path = self._items[idx]
        return (read_image(img_path).astype(np.float32),
                read_grey(mask_path))

    def _out(self, sample):
        return self.transform(sample) if self.transform is not None \
            else sample


class SalientObjectDetectionDataset(_PairFolderBase):
    """Samples {"image", "mask": [h, w] f32, 1 where the mask is over 127,
    "scale", "size"}."""

    def __getitem__(self, idx):
        image, mask = self._load_pair(idx)
        return self._out(_sample(image, mask=(mask > 127).astype(
            np.float32)))


class HumanMattingDataset(_PairFolderBase):
    """The mask holds the alpha in 0..255. Samples {"image", "alpha": [h,
    w] f32 0..1, "trimap": [h, w] f32, 255 on the eroded alpha > 0.95, 128
    on the rest of the dilated alpha > 0.05, else 0, "scale", "size"}."""

    def __init__(self, *args, trimap_kernel: int = 15, **kwargs):
        super().__init__(*args, **kwargs)
        self.trimap_kernel = trimap_kernel

    def __getitem__(self, idx):
        image, alpha8 = self._load_pair(idx)
        alpha = alpha8.astype(np.float32) / 255.0
        k = ellipse_element(self.trimap_kernel)
        eroded = erode((alpha > 0.95).astype(np.uint8), k)
        dilated = dilate((alpha > 0.05).astype(np.uint8), k)
        trimap = np.zeros_like(alpha8, np.float32)
        trimap[dilated > 0] = 128.0
        trimap[eroded > 0] = 255.0
        return self._out(_sample(image, alpha=alpha, trimap=trimap))


class HumanParsingDataset(_PairFolderBase):
    """Samples {"image", "mask": [h, w] int32 class ids, "scale",
    "size"}."""

    def __getitem__(self, idx):
        image, mask = self._load_pair(idx)
        return self._out(_sample(image, mask=mask.astype(np.int32)))


class FaceParsingDataset(HumanParsingDataset):
    pass


class FaceDetectionDataset:
    """Samples {"image", "annots": [n, 5] f32 boxes with class 0, "scale",
    "size"}; the images of each set in sorted order, those the json
    names."""

    def __init__(self, root_dir: str, set_name_list=("wider_face",),
                 set_type: str = "train",
                 transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.set_name_list = list(set_name_list)
        self.set_type = set_type
        self.transform = transform
        self._items = None

    def _scan(self):
        if self._items is not None:
            return
        items = []
        for set_name in self.set_name_list:
            img_dir = os.path.join(self.root_dir, set_name, "images",
                                   self.set_type)
            json_path = os.path.join(self.root_dir, set_name, "annotations",
                                     f"{set_name}_{self.set_type}.json")
            if not (os.path.isdir(img_dir) and os.path.exists(json_path)):
                continue
            with open(json_path, encoding="utf-8") as f:
                labels = json.load(f)
            items.extend((os.path.join(img_dir, name),
                          labels[name]["face_box"])
                         for name in sorted(os.listdir(img_dir))
                         if name in labels)
        self._items = items

    def __len__(self):
        self._scan()
        return len(self._items)

    def __getitem__(self, idx):
        self._scan()
        path, boxes = self._items[idx]
        image = read_image(path).astype(np.float32)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        annots = np.concatenate(
            [boxes, np.zeros((boxes.shape[0], 1), np.float32)], axis=1)
        sample = _sample(image, annots=annots)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
