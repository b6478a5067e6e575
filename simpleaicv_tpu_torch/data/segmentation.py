"""Semantic-segmentation transforms, collater and synthetic dataset
(counterpart of ``simpleaicv_tpu/data/segmentation.py``), without OpenCV.
A sample is a dict: 'image' HWC f32, 'mask' HW int, 'scale' and 'size'
[2].

The JAX package resizes with OpenCV. Here the image goes through
``data.transforms.resize_bilinear`` (``F.interpolate`` at pixel centres,
no antialiasing: ``INTER_LINEAR``) and the mask through
``data.interactive_segmentation.resize_nearest`` (source index
``floor(dst * in / out)``: ``INTER_NEAREST``). ``SegPhotoMetricDistortion``'s
RGB <-> HSV round trip is OpenCV's 8-bit one in numpy: H in [0, 180), S and
V in [0, 255], the forward in OpenCV's 12-bit fixed point, the inverse in
f32. The random transforms draw from the global ``random`` state in the
JAX package's order, so seeding it alike gives the JAX sample.
"""

from __future__ import annotations

import random

import numpy as np

from .interactive_segmentation import resize_nearest
from .transforms import resize_bilinear

__all__ = ["SegResize", "SegRandomCropResize", "SegRandomHorizontalFlip",
           "SegPhotoMetricDistortion", "SegNormalize",
           "SemanticSegmentationCollater", "FakeSegmentationDataset",
           "rgb_to_hsv_u8", "hsv_to_rgb_u8"]


def _resize_pair(image, mask, nh: int, nw: int):
    return (resize_bilinear(image, nh, nw),
            resize_nearest(mask, nh, nw).astype(mask.dtype))


class SegResize:
    """Scales the long side to ``resize``, keeping the aspect ratio."""

    def __init__(self, resize=512):
        self.resize = resize

    def __call__(self, sample):
        h, w = sample["image"].shape[:2]
        factor = self.resize / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        sample["image"], sample["mask"] = _resize_pair(
            sample["image"], sample["mask"], nh, nw)
        sample["scale"] = sample.get("scale", 1.0) * np.float32(factor)
        sample["size"] = np.array([nh, nw], np.float32)
        return sample


class SegRandomCropResize:
    """Scales the long side to ``max(image_scale)`` times a ratio drawn from
    ``multi_scale_range``, then crops ``crop_size`` at random, drawing the
    crop again (up to 10 times) while one class covers ``cat_max_ratio`` or
    more of the crop's labelled pixels."""

    def __init__(self, image_scale=(2048, 512), multi_scale_range=(0.5, 2.0),
                 crop_size=(512, 512), cat_max_ratio=0.75, ignore_index=255):
        self.image_scale = image_scale
        self.multi_scale_range = multi_scale_range
        self.crop_size = crop_size
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def _rand_crop_bbox(self, h: int, w: int):
        ch = min(self.crop_size[1], h)
        cw = min(self.crop_size[0], w)
        y = random.randint(0, h - ch)
        x = random.randint(0, w - cw)
        return y, y + ch, x, x + cw

    def __call__(self, sample):
        h, w = sample["image"].shape[:2]
        ratio = random.uniform(*self.multi_scale_range)
        factor = max(self.image_scale) * ratio / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        image, mask = _resize_pair(sample["image"], sample["mask"], nh, nw)

        bbox = self._rand_crop_bbox(nh, nw)
        if self.cat_max_ratio < 1.0:
            for _ in range(10):
                y1, y2, x1, x2 = bbox
                labels, counts = np.unique(mask[y1:y2, x1:x2],
                                           return_counts=True)
                counts = counts[labels != self.ignore_index]
                if counts.size > 1 and counts.max() / counts.sum() < \
                        self.cat_max_ratio:
                    break
                bbox = self._rand_crop_bbox(nh, nw)
        y1, y2, x1, x2 = bbox
        sample["image"] = image[y1:y2, x1:x2]
        sample["mask"] = mask[y1:y2, x1:x2]
        sample["size"] = np.array(sample["image"].shape[:2], np.float32)
        return sample


class SegRandomHorizontalFlip:

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if random.random() < self.prob:
            sample["image"] = np.ascontiguousarray(sample["image"][:, ::-1])
            sample["mask"] = np.ascontiguousarray(sample["mask"][:, ::-1])
        return sample


_HSV_SHIFT = 12
_SDIV = np.concatenate([[0], np.rint(
    (255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))]).astype(
        np.int64)
_HDIV = np.concatenate([[0], np.rint(
    (180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))
]).astype(np.int64)


def rgb_to_hsv_u8(rgb):
    """OpenCV's ``cvtColor(COLOR_RGB2HSV)`` of a uint8 [h, w, 3] image:
    uint8 H in [0, 180), S and V in [0, 255], in its fixed point."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# (b, g, r) as indices into (v, v(1 - s), v(1 - s f), v(1 - s(1 - f))) by
# the hue's sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb_u8(hsv):
    """OpenCV's ``cvtColor(COLOR_HSV2RGB)`` of a uint8 [h, w, 3] image (H
    in [0, 180)): uint8 RGB, computed in f32 and truncated."""
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.fmod(h, np.float32(6.0))
    sector = np.floor(h)
    f = h - sector
    sector = sector.astype(np.int64)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    f = np.where(bad, np.float32(0.0), f)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * f),
                    v * (one - s * (one - f))], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * np.float32(255.0)
    return np.clip(rgb, 0, 255).astype(np.uint8)


class SegPhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter, each with
    probability ``prob``; the image goes through 8-bit HSV either way."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18, prob=0.5):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta
        self.prob = prob

    def __call__(self, sample):
        img = sample["image"].astype(np.float32)
        if random.random() < self.prob:
            img += random.uniform(-self.brightness_delta,
                                  self.brightness_delta)
        if random.random() < self.prob:
            img *= random.uniform(*self.contrast_range)
        hsv = rgb_to_hsv_u8(np.clip(img, 0, 255).astype(np.uint8)).astype(
            np.float32)
        if random.random() < self.prob:
            hsv[..., 1] *= random.uniform(*self.saturation_range)
        if random.random() < self.prob:
            hsv[..., 0] = (hsv[..., 0] +
                           random.uniform(-self.hue_delta, self.hue_delta)) \
                % 180
        sample["image"] = hsv_to_rgb_u8(
            np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
        return sample


class SegNormalize:

    def __call__(self, sample):
        sample["image"] = (sample["image"] / 255.0).astype(np.float32)
        return sample


class SemanticSegmentationCollater:
    """-> image [B, S, S, 3] f32, mask [B, S, S] int32 and size [B, 2] on
    square canvases; the mask's padding is ``ignore_index`` (0 when it is
    None or 0)."""

    def __init__(self, resize=512, ignore_index=255):
        self.resize = resize
        self.ignore_index = ignore_index

    def __call__(self, samples):
        n = len(samples)
        images = np.zeros((n, self.resize, self.resize, 3), np.float32)
        masks = np.full((n, self.resize, self.resize),
                        self.ignore_index if self.ignore_index else 0,
                        np.int32)
        sizes = np.zeros((n, 2), np.float32)
        for i, s in enumerate(samples):
            img, m = s["image"], s["mask"]
            images[i, :img.shape[0], :img.shape[1]] = img
            masks[i, :m.shape[0], :m.shape[1]] = m
            sizes[i] = s.get("size", img.shape[:2])
        return {"image": images, "mask": masks, "size": sizes}


class FakeSegmentationDataset:
    """Synthetic: three class-coloured rectangles on noise, seeded by the
    sample's index."""

    def __init__(self, num_samples=32, image_hw=128, num_classes=6,
                 ignore_index=255, transform=None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        hw = self.image_hw
        image = rng.uniform(0, 40, (hw, hw, 3)).astype(np.float32)
        mask = np.zeros((hw, hw), np.int32)
        for _ in range(3):
            cls = rng.randint(1, self.num_classes)
            w, h = rng.randint(hw // 6, hw // 2, 2)
            x, y = rng.randint(0, hw - w), rng.randint(0, hw - h)
            mask[y:y + h, x:x + w] = cls
            image[y:y + h, x:x + w] = 40.0 * cls
        sample = {"image": image, "mask": mask, "scale": np.float32(1.0),
                  "size": np.array([hw, hw], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
