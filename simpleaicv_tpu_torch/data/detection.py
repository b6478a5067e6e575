"""Detection transforms and collaters (counterpart of
``simpleaicv_tpu/data/detection.py``), without OpenCV. A sample is a dict:
'image' HWC f32, 'annots' [M, 5] as (x1, y1, x2, y2, class), 'scale' and
'size' [2].

The resize is OpenCV's ``INTER_LINEAR`` in the JAX package; here it is
``data.transforms.resize_bilinear`` (``F.interpolate`` at pixel centres,
no antialiasing). ``RandomTranslate`` shifts by whole pixels with zero
fill, which is what the JAX package's ``cv2.warpAffine`` does with an
integer translation. The random transforms draw from the global ``random``
and ``numpy.random`` state, as the JAX package's do, so seeding the globals
alike gives the JAX sample.
"""

from __future__ import annotations

import random

import numpy as np

from .transforms import resize_bilinear

__all__ = ["DetectionResize", "RandomHorizontalFlip", "RandomCrop",
           "RandomTranslate", "Normalize", "DetectionCollater",
           "DETRDetectionCollater"]

_RESIZE_TYPES = ("retina_style", "yolo_style")


def _canvas(resize: int, resize_type: str) -> int:
    """The collaters' square side: ``resize``, or ``resize * 1333 / 800``
    for the retina style."""
    if resize_type not in _RESIZE_TYPES:
        raise ValueError(f"unknown resize_type {resize_type!r}")
    if resize_type == "retina_style":
        return int(round(resize * 1333.0 / 800))
    return resize


class DetectionResize:
    """Resizes the image and its boxes. ``yolo_style``: the long side to
    ``resize``; ``retina_style``: the short side to ``resize`` with the long
    side at most ``resize * 1333 / 800``. With ``multi_scale``, ``resize``
    is replaced per sample by a multiple of ``stride`` in
    ``multi_scale_range`` of it, drawn from ``numpy.random``. Sets 'scale'
    (times the factor) and 'size' (the resized height and width)."""

    def __init__(self, resize=800, stride=32, resize_type="retina_style",
                 multi_scale=False, multi_scale_range=(0.8, 1.0)):
        if resize_type not in _RESIZE_TYPES:
            raise ValueError(f"unknown resize_type {resize_type!r}")
        self.resize = resize
        self.stride = stride
        self.resize_type = resize_type
        self.multi_scale = multi_scale
        self.multi_scale_range = multi_scale_range
        self.ratio = 1333.0 / 800

    def _pick_resize(self):
        lo = int(self.multi_scale_range[0] * self.resize)
        hi = int(self.multi_scale_range[1] * self.resize)
        sizes = sorted({i // self.stride * self.stride
                        for i in range(lo, hi + self.stride)})
        return sizes[np.random.randint(0, len(sizes))]

    def __call__(self, sample):
        image, annots = sample["image"], sample["annots"]
        h, w = image.shape[:2]
        if self.resize_type == "retina_style":
            short = self._pick_resize() if self.multi_scale else self.resize
            scales = (short, int(round(self.resize * self.ratio)))
            long_e, short_e = max(scales), min(scales)
            factor = min(long_e / max(h, w), short_e / min(h, w))
        else:
            final = self._pick_resize() if self.multi_scale else self.resize
            factor = final / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        sample["image"] = resize_bilinear(image, nh, nw)
        annots = annots.copy()
        if annots.shape[0] > 0:
            annots[:, :4] *= np.float32(factor)
        sample["annots"] = annots
        sample["scale"] = sample.get("scale", 1.0) * np.float32(factor)
        sample["size"] = np.array([nh, nw], np.float32)
        return sample


class RandomHorizontalFlip:
    """Mirrors the image and its boxes with probability ``prob``."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if random.random() < self.prob:
            image, annots = sample["image"], sample["annots"].copy()
            w = image.shape[1]
            sample["image"] = np.ascontiguousarray(image[:, ::-1, :])
            if annots.shape[0] > 0:
                x1 = annots[:, 0].copy()
                annots[:, 0] = w - annots[:, 2]
                annots[:, 2] = w - x1
            sample["annots"] = annots
        return sample


class RandomCrop:
    """With probability ``prob``, crops to a random window that keeps every
    box whole; 'size' becomes the crop's."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if random.random() >= self.prob or sample["annots"].shape[0] == 0:
            return sample
        image, annots = sample["image"], sample["annots"].copy()
        h, w = image.shape[:2]
        boxes = annots[:, :4]
        min_x1, min_y1 = boxes[:, 0].min(), boxes[:, 1].min()
        max_x2, max_y2 = boxes[:, 2].max(), boxes[:, 3].max()
        crop_x1 = random.randint(0, max(int(min_x1), 0))
        crop_y1 = random.randint(0, max(int(min_y1), 0))
        crop_x2 = random.randint(min(int(max_x2), w - 1), w - 1) + 1
        crop_y2 = random.randint(min(int(max_y2), h - 1), h - 1) + 1
        sample["image"] = image[crop_y1:crop_y2, crop_x1:crop_x2]
        annots[:, [0, 2]] -= crop_x1
        annots[:, [1, 3]] -= crop_y1
        sample["annots"] = annots
        sample["size"] = np.array(sample["image"].shape[:2], np.float32)
        return sample


def shift_image(image, tx: int, ty: int):
    """``image`` moved by (tx, ty) whole pixels, zeros where nothing moved
    in: out[y, x] = image[y - ty, x - tx]."""
    h, w = image.shape[:2]
    out = np.zeros_like(image)
    if abs(tx) < w and abs(ty) < h:
        out[max(ty, 0):h + min(ty, 0), max(tx, 0):w + min(tx, 0)] = \
            image[max(-ty, 0):h - max(ty, 0), max(-tx, 0):w - max(tx, 0)]
    return out


class RandomTranslate:
    """With probability ``prob``, shifts the image and its boxes by whole
    pixels, as far as keeps every box inside."""

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if random.random() >= self.prob or sample["annots"].shape[0] == 0:
            return sample
        image, annots = sample["image"], sample["annots"].copy()
        h, w = image.shape[:2]
        boxes = annots[:, :4]
        tx_max = int(min(boxes[:, 0].min(), w - boxes[:, 2].max()) - 1)
        ty_max = int(min(boxes[:, 1].min(), h - boxes[:, 3].max()) - 1)
        if tx_max < 1 and ty_max < 1:
            return sample
        tx = random.randint(-tx_max, tx_max) if tx_max >= 1 else 0
        ty = random.randint(-ty_max, ty_max) if ty_max >= 1 else 0
        sample["image"] = shift_image(image, tx, ty)
        annots[:, [0, 2]] += tx
        annots[:, [1, 3]] += ty
        sample["annots"] = annots
        return sample


class Normalize:
    """Scales the image to [0, 1] in f32."""

    def __call__(self, sample):
        sample["image"] = (sample["image"] / 255.0).astype(np.float32)
        return sample


class DetectionCollater:
    """Pads images onto a square canvas of side ``resize`` (the retina
    style one of ``resize * 1333 / 800``) and annotations to
    ``max_annots_num`` rows of -1; stacks 'scale' and 'size'."""

    def __init__(self, resize=800, resize_type="retina_style",
                 max_annots_num=100):
        self.resize = _canvas(resize, resize_type)
        self.max_annots_num = max_annots_num

    def __call__(self, samples):
        n = len(samples)
        images = np.zeros((n, self.resize, self.resize, 3), np.float32)
        annots = np.full((n, self.max_annots_num, 5), -1.0, np.float32)
        scales = np.zeros((n,), np.float32)
        sizes = np.zeros((n, 2), np.float32)
        for i, s in enumerate(samples):
            img = s["image"]
            images[i, :img.shape[0], :img.shape[1]] = img
            a = s["annots"]
            if a.shape[0] > 0:
                annots[i, :min(a.shape[0], self.max_annots_num)] = \
                    a[:self.max_annots_num]
            scales[i] = s.get("scale", 1.0)
            sizes[i] = s.get("size", img.shape[:2])
        return {"image": images, "annots": annots, "scale": scales,
                "size": sizes}


class DETRDetectionCollater:
    """Pads images onto a square canvas of side ``resize`` (the retina style
    one of ``resize * 1333 / 800``) and annotations to ``max_annots_num``
    rows of -1, and adds the padding mask (1 = padding) and
    'scaled_annots': (cx, cy, w, h) normalised by the image's own width and
    height, and the class."""

    def __init__(self, resize=800, resize_type="yolo_style",
                 max_annots_num=100):
        self.resize = _canvas(resize, resize_type)
        self.max_annots_num = max_annots_num

    def __call__(self, samples):
        n, r = len(samples), self.resize
        images = np.zeros((n, r, r, 3), np.float32)
        masks = np.ones((n, r, r), np.float32)
        annots = np.full((n, self.max_annots_num, 5), -1.0, np.float32)
        scaled = np.full((n, self.max_annots_num, 5), -1.0, np.float32)
        scales = np.zeros((n,), np.float32)
        sizes = np.zeros((n, 2), np.float32)
        for i, s in enumerate(samples):
            img = s["image"]
            h, w = img.shape[:2]
            images[i, :h, :w] = img
            masks[i, :h, :w] = 0.0
            a = s["annots"]
            m = min(a.shape[0], self.max_annots_num)
            if m > 0:
                annots[i, :m] = a[:m]
                ctr = (a[:m, 0:2] + a[:m, 2:4]) / 2
                wh = a[:m, 2:4] - a[:m, 0:2]
                size_vec = np.array([w, h, w, h], np.float32)
                scaled[i, :m, :4] = np.concatenate([ctr, wh], 1) / size_vec
                scaled[i, :m, 4] = a[:m, 4]
            scales[i] = s.get("scale", 1.0)
            sizes[i] = s.get("size", img.shape[:2])
        return {"image": images, "mask": masks, "annots": annots,
                "scaled_annots": scaled, "scale": scales, "size": sizes}
