"""COCO instance-segmentation reader (counterpart of
``simpleaicv_tpu/data/datasets/coco_instance.py``): per-instance boxes and
masks, a polygon rasterised by ``data/raster.py::fill_poly`` (OpenCV's
``fillPoly``), an RLE, uncompressed or compressed, decoded by
``data/rle.py``."""

from __future__ import annotations

import numpy as np

from ..raster import fill_poly
from ..rle import rle_decode
from .coco import CocoDetection

__all__ = ["CocoInstanceSegmentation", "segmentation_to_mask"]


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """A COCO or SA-1B ``segmentation`` -> uint8 [h, w] 0/1 mask: a list of
    polygons (each vertex truncated to an int, as the JAX reader's
    ``astype(np.int32)``), or an RLE dict whose size defaults to [h, w]."""
    if isinstance(seg, dict):
        if "size" not in seg:
            seg = dict(seg, size=[h, w])
        return rle_decode(seg)
    mask = np.zeros((h, w), np.uint8)
    for poly in seg:
        pts = np.asarray(poly, np.float32).reshape(-1, 2).astype(np.int32)
        fill_poly(mask, pts, 1)
    return mask


class CocoInstanceSegmentation(CocoDetection):
    """Samples: the detection sample's image, "annots" [M, 5] and "masks"
    (a list of [h, w] f32 0/1), one per kept instance; crowd annotations
    and boxes with a side under 1 dropped."""

    def __getitem__(self, idx):
        self._load()
        image_id = self.image_ids[idx]
        image = self.load_image(image_id)
        h, w = image.shape[:2]
        annots, masks = [], []
        for a in self.anns_by_image.get(image_id, []):
            x, y, bw, bh = a["bbox"]
            if bw < 1 or bh < 1:
                continue
            annots.append([x, y, x + bw, y + bh,
                           self.cat_id_to_label[a["category_id"]]])
            masks.append(segmentation_to_mask(
                a.get("segmentation", []), h, w).astype(np.float32))
        annots = (np.asarray(annots, np.float32) if annots
                  else np.zeros((0, 5), np.float32))
        sample = {"image": image, "annots": annots, "masks": masks,
                  "scale": np.float32(1.0),
                  "size": np.array([h, w], np.float32),
                  "image_id": image_id}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
