"""Binary mask PNG labels -> SA-1B style per-image JSON annotations
(counterpart of ``simpleaicv_tpu/data/processing/sam_labels.py``), without
OpenCV: salient- or matting-style image.jpg + mask.png pairs become the
{'image': ..., 'annotations': [{..., 'segmentation': COCO compressed
RLE}]} files that ``data/datasets/sam_segmentation.py`` reads.

The mask's box is ``raster.bounding_rect`` (``cv2.boundingRect``), its RLE
``data/rle.py``'s, its grey read ``image_io.read_grey``
(``IMREAD_GRAYSCALE``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..raster import bounding_rect
from ..rle import rle_encode
from .common import IMREAD_GRAYSCALE, imread_any, imwrite_any


def mask_to_sa1b_record(image_name: str, mask: np.ndarray) -> dict:
    """Binary [H,W] mask -> one SA-1B annotation json record."""
    h, w = mask.shape[:2]
    mask = (np.asarray(mask) > 0).astype(np.uint8)
    x, y, bw, bh = bounding_rect(mask)
    stem = os.path.splitext(image_name)[0]
    return {
        "image": {"image_id": stem, "width": int(w), "height": int(h),
                  "file_name": stem + ".jpg"},
        "annotations": [{
            "id": 0,
            "segmentation": rle_encode(mask),
            "bbox": [int(x), int(y), int(bw), int(bh)],
            "area": int(mask.sum()),
            "predicted_iou": 1,
            "stability_score": 1,
            "point_coords": None,
        }],
    }


def convert_mask_folder_to_sa1b(root: str, out_dir: str,
                                set_type: str = "train",
                                threshold: float = 0.5,
                                log=print) -> int:
    """root/<set_type>/ holding <stem>.jpg + <stem>.png binary masks ->
    out_dir/<set_type>/ with <stem>.jpg + <stem>.json (the SA-1B layout
    ``SAMSegmentationDataset`` reads). A mask value v is foreground where
    ``v / 255 >= threshold`` in f32."""
    src = os.path.join(root, set_type)
    dst = os.path.join(out_dir, set_type)
    os.makedirs(dst, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src)):
        if not name.lower().endswith((".jpg", ".jpeg")):
            continue
        stem = os.path.splitext(name)[0]
        mask_path = os.path.join(src, stem + ".png")
        if not os.path.exists(mask_path):
            continue
        image = imread_any(os.path.join(src, name))
        mask8 = imread_any(mask_path, IMREAD_GRAYSCALE)
        if image is None or mask8 is None:
            continue
        mask = (mask8.astype(np.float32) / 255.0 >= threshold)
        record = mask_to_sa1b_record(name, mask.astype(np.uint8))
        imwrite_any(os.path.join(dst, stem + ".jpg"), image)
        with open(os.path.join(dst, stem + ".json"), "w",
                  encoding="utf-8") as f:
            json.dump(record, f)
        n += 1
    if log:
        log(f"sa1b convert {src} -> {dst}: {n} images")
    return n
