"""Packed caches for detection and SAM (counterpart of
``simpleaicv_tpu/data/packed_tasks.py``): each sample letterboxed once at
pack time to the training canvas and stored as fixed-stride uint8 records
(``data/packed.py``); an epoch is then one gather per field and a
vectorised collate of the gathered batch dict.

Detection record (the geometry of ``DetectionResize(yolo_style)`` and
``DetectionCollater``): image [S, S, 3] u8 (the long side resized to S,
anchored top-left, zero pad), annots [max_annots, 5] f32 (x1, y1, x2, y2,
class in canvas pixels, -1 pad), scale f32, size [2] f32 (the resized h,
w before the pad).

SAM record (the geometry of ``SamResize`` and the SAM collater's canvas):
image [S, S, 3] u8, mask_bits [S, S / 8] u8 (``np.packbits`` of the
binary mask), box [4] f32 (the mask's tight box), point_candidates [K, 2]
f32 (positive pixels the collater draws its clicks from, -1 pad), scale
f32.

The ``Packed*Collate`` classes take the gathered batch dict and carry
``packed_batch = True``, which sends a ``PackedDataset`` train set through
the ``PackedLoader`` with them (``core/trainer.py``).

Against the JAX package: the letterbox resize is ``data.transforms.
resize_bilinear`` (``F.interpolate``, bilinear at pixel centres without
antialiasing) where the JAX writer calls ``cv2.resize``; on this CPU the
uint8 canvases part from cv2's by at most one level
(``tests/test_torch_packed.py``). The mask's nearest resize is
``interactive_segmentation.resize_nearest``, a gather at OpenCV's
``INTER_NEAREST`` places computed in f64 (``raster.nearest_indices``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .interactive_segmentation import noise_bbox, resize_nearest
from .packed import PackWriter
from .transforms import resize_bilinear

__all__ = ["pack_detection_dataset", "PackedDetectionCollate",
           "pack_sam_dataset", "PackedSAMCollate"]


def _letterbox_u8(image: np.ndarray, hw: int):
    """The long side resized to ``hw`` (the short side rounded), anchored
    top-left on a zero uint8 canvas; (canvas, factor, [resized h, w])."""
    h, w = image.shape[:2]
    factor = hw / max(h, w)
    nh, nw = int(round(h * factor)), int(round(w * factor))
    resized = resize_bilinear(image, nh, nw)
    canvas = np.zeros((hw, hw, 3), np.uint8)
    canvas[:nh, :nw] = np.clip(np.round(resized), 0, 255).astype(np.uint8)
    return canvas, np.float32(factor), np.array([nh, nw], np.float32)


def pack_detection_dataset(dataset, out_path: str, image_hw: int = 1024,
                           max_annots: int = 100,
                           meta: Optional[dict] = None,
                           progress_every: int = 0) -> str:
    """Packs a detection dataset (samples {image [h, w, 3] 0..255, annots
    [n, 5] x1, y1, x2, y2, class in the original pixels}, no transform) at
    the training canvas. The fixed geometry leaves out the host's random
    flips."""
    n = len(dataset)
    fields = {
        "image": ((image_hw, image_hw, 3), "uint8"),
        "annots": ((max_annots, 5), "float32"),
        "scale": ((), "float32"),
        "size": ((2,), "float32"),
    }
    m = {"task": "detection", "image_hw": image_hw,
         "max_annots": max_annots, "resize_type": "yolo_style"}
    m.update(meta or {})
    if getattr(dataset, "class_names", None):
        m.setdefault("class_names", list(dataset.class_names))
    with PackWriter(out_path, fields, n, meta=m) as w:
        for i in range(n):
            s = dataset[i]
            img, factor, size = _letterbox_u8(
                np.asarray(s["image"], np.float32), image_hw)
            annots = np.full((max_annots, 5), -1.0, np.float32)
            a = np.asarray(s["annots"], np.float32).reshape(-1, 5)
            if a.shape[0] > 0:
                a = a[:max_annots].copy()
                a[:, :4] *= factor
                annots[:a.shape[0]] = a
            w.add({"image": img, "annots": annots,
                   "scale": np.float32(s.get("scale", 1.0)) * factor,
                   "size": size}, index=i)
            if progress_every and (i + 1) % progress_every == 0:
                print(f"packed {i + 1}/{n}")
    return out_path


class PackedDetectionCollate:
    """The gathered batch -> the detection step's f32 batch: {image / 255,
    annots, scale, size}."""

    packed_batch = True

    def __call__(self, batch):
        return {
            "image": batch["image"].astype(np.float32) / 255.0,
            "annots": batch["annots"],
            "scale": batch["scale"],
            "size": batch["size"],
        }


def pack_sam_dataset(dataset, out_path: str, image_hw: int = 1024,
                     max_point_candidates: int = 32, seed: int = 0,
                     meta: Optional[dict] = None,
                     progress_every: int = 0) -> str:
    """Packs a SAM dataset (samples {image [h, w, 3] 0..255, mask [h, w]
    binary}, no transform) at the SAM canvas: the mask bit-packed, its
    tight box and up to ``max_point_candidates`` of its pixels drawn from
    ``RandomState(seed)``."""
    if image_hw % 8:
        raise ValueError(f"image_hw {image_hw} is not a multiple of 8")
    n = len(dataset)
    fields = {
        "image": ((image_hw, image_hw, 3), "uint8"),
        "mask_bits": ((image_hw, image_hw // 8), "uint8"),
        "box": ((4,), "float32"),
        "point_candidates": ((max_point_candidates, 2), "float32"),
        "scale": ((), "float32"),
    }
    m = {"task": "sam", "image_hw": image_hw,
         "max_point_candidates": max_point_candidates}
    m.update(meta or {})
    rng = np.random.RandomState(seed)
    with PackWriter(out_path, fields, n, meta=m) as w:
        for i in range(n):
            s = dataset[i]
            img, factor, size = _letterbox_u8(
                np.asarray(s["image"], np.float32), image_hw)
            nh, nw = int(size[0]), int(size[1])
            mask = resize_nearest(np.asarray(s["mask"], np.float32), nh, nw)
            canvas = np.zeros((image_hw, image_hw), np.uint8)
            canvas[:nh, :nw] = (mask > 0.5).astype(np.uint8)

            ys, xs = np.nonzero(canvas)
            box = np.zeros(4, np.float32)
            cands = np.full((max_point_candidates, 2), -1.0, np.float32)
            if len(ys) > 0:
                box[:] = (xs.min(), ys.min(), xs.max(), ys.max())
                k = min(max_point_candidates, len(ys))
                sel = rng.choice(len(ys), k, replace=False)
                cands[:k, 0] = xs[sel]
                cands[:k, 1] = ys[sel]
            w.add({"image": img,
                   "mask_bits": np.packbits(canvas, axis=1),
                   "box": box, "point_candidates": cands,
                   "scale": np.float32(s.get("scale", 1.0)) * factor},
                  index=i)
            if progress_every and (i + 1) % progress_every == 0:
                print(f"packed {i + 1}/{n}")
    return out_path


class PackedSAMCollate:
    """The gathered batch -> the SAM collater's batch: image [B, S, S, 3]
    f32 / 255, mask [B, S, S] f32, prompt_point [B, max_points, 3] (-1
    pad), prompt_box [B, 4], prompt_mask [B, S/4, S/4, 1] (the mask's
    nearest downsample). The clicks come from the packed candidates, drawn
    from ``RandomState(seed)``; the box noise from numpy's global state, as
    in the JAX collater."""

    packed_batch = True

    def __init__(self, positive_point_num_range=(1, 9), max_points: int = 9,
                 use_noise_bbox: bool = True, seed: int = 0):
        self.point_range = positive_point_num_range
        self.max_points = max_points
        self.use_noise_bbox = use_noise_bbox
        self._rng = np.random.RandomState(seed)

    def __call__(self, batch):
        imgs = batch["image"]
        b, s = imgs.shape[0], imgs.shape[1]
        mask = np.unpackbits(batch["mask_bits"], axis=2,
                             count=s).astype(np.float32)
        points = np.full((b, self.max_points, 3), -1.0, np.float32)
        boxes = np.asarray(batch["box"], np.float32).copy()
        cands = batch["point_candidates"]
        for i in range(b):
            valid = cands[i, :, 0] >= 0
            nv = int(valid.sum())
            if nv == 0:
                continue
            k = min(self._rng.randint(self.point_range[0],
                                      self.point_range[1] + 1),
                    self.max_points, nv)
            sel = self._rng.choice(nv, k, replace=False)
            points[i, :k, :2] = cands[i, sel]
            points[i, :k, 2] = 1.0
            if self.use_noise_bbox:
                boxes[i] = noise_bbox(boxes[i], s, s, np.random)
        return {
            "image": imgs.astype(np.float32) / 255.0,
            "mask": mask,
            "prompt_point": points,
            "prompt_box": boxes,
            "prompt_mask": mask[:, ::4, ::4, None],
        }
