"""Classification transforms (counterpart of
``simpleaicv_tpu/data/transforms.py``), on the host. Each is a callable over
a sample dict with 'image' (HWC f32 numpy) and 'label'.

The two resizes (``RandomResizedCrop``, ``Resize``) are OpenCV's
``INTER_LINEAR`` in the JAX package; here they are
``torch.nn.functional.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` on a CPU tensor, which samples the same source points
(pixel centres, indices clamped at the border) and needs no OpenCV.

The random transforms draw, in the JAX package's order, from ``rng`` (a
``random.Random``) and, for the numpy draws, ``np_rng`` (a
``numpy.random.RandomState``). Without them they draw from the global
``random`` and ``numpy.random`` state as the JAX package does, so seeding
the globals alike gives the JAX sample.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "Opencv2PIL", "PIL2Opencv", "Pad", "RandomHorizontalFlip", "RandomCrop",
    "RandomResizedCrop", "Resize", "CenterCrop", "Normalize",
    "MeanStdNormalize", "RandomErasing", "PCAJitter", "Compose",
    "resize_bilinear",
    # reference-name aliases
    "TorchPad", "TorchRandomHorizontalFlip", "TorchRandomCrop",
    "TorchRandomResizedCrop", "TorchResize", "TorchCenterCrop",
    "TorchMeanStdNormalize",
]


def _py(rng):
    """The draws' source: ``rng``, or the global ``random`` state (a
    module cannot be pickled, so a transform keeps None, not the module,
    and crosses to a worker process)."""
    return random if rng is None else rng


def _np(np_rng):
    return np.random if np_rng is None else np_rng


def resize_bilinear(image, out_h: int, out_w: int):
    """[h, w, c] -> [out_h, out_w, c] f32 by bilinear interpolation at pixel
    centres (OpenCV's ``INTER_LINEAR`` on f32, without antialiasing)."""
    t = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    out = F.interpolate(t.permute(2, 0, 1)[None], size=(out_h, out_w),
                        mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


class Compose:

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class Opencv2PIL:
    """Identity (numpy end to end); kept for the configs' surface."""

    def __call__(self, sample):
        return sample


class PIL2Opencv:

    def __call__(self, sample):
        return sample


class Pad:

    def __init__(self, padding=4, fill=0, padding_mode="reflect"):
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, sample):
        image = sample["image"]
        p = self.padding
        if self.padding_mode == "reflect":
            image = np.pad(image, ((p, p), (p, p), (0, 0)), mode="reflect")
        else:
            image = np.pad(image, ((p, p), (p, p), (0, 0)), mode="constant",
                           constant_values=self.fill)
        sample["image"] = image
        return sample


class RandomHorizontalFlip:

    def __init__(self, prob=0.5, rng: random.Random | None = None):
        self.prob = prob
        self.rng = rng

    def __call__(self, sample):
        if _py(self.rng).random() < self.prob:
            sample["image"] = np.ascontiguousarray(sample["image"][:, ::-1, :])
        return sample


class RandomCrop:

    def __init__(self, resize=224, rng: random.Random | None = None):
        self.resize = int(resize)
        self.rng = rng

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        th = tw = self.resize
        rng = _py(self.rng)
        y = rng.randint(0, max(h - th, 0))
        x = rng.randint(0, max(w - tw, 0))
        sample["image"] = image[y:y + th, x:x + tw]
        return sample


class RandomResizedCrop:
    """torchvision's RandomResizedCrop: an area scale in ``scale`` and a
    log-uniform aspect in ``ratio``, 10 tries, then a centre crop; the crop
    is resized to ``resize`` square."""

    def __init__(self, resize=224, scale=(0.08, 1.0), ratio=(3. / 4., 4. / 3.),
                 rng: random.Random | None = None):
        self.resize = int(resize)
        self.scale = scale
        self.ratio = ratio
        self.rng = rng

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        area = h * w
        rng = _py(self.rng)
        for _ in range(10):
            target_area = rng.uniform(*self.scale) * area
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                y = rng.randint(0, h - ch)
                x = rng.randint(0, w - cw)
                crop = image[y:y + ch, x:x + cw]
                break
        else:
            in_ratio = w / h
            if in_ratio < self.ratio[0]:
                cw, ch = w, int(round(w / self.ratio[0]))
            elif in_ratio > self.ratio[1]:
                ch, cw = h, int(round(h * self.ratio[1]))
            else:
                cw, ch = w, h
            y = (h - ch) // 2
            x = (w - cw) // 2
            crop = image[y:y + ch, x:x + cw]
        sample["image"] = resize_bilinear(crop, self.resize, self.resize)
        return sample


class Resize:
    """torchvision's Resize(int): the short side to ``resize``, keeping the
    aspect."""

    def __init__(self, resize=224):
        self.resize = int(resize)

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        if h <= w:
            nh, nw = self.resize, int(round(w * self.resize / h))
        else:
            nh, nw = int(round(h * self.resize / w)), self.resize
        sample["image"] = resize_bilinear(image, nh, nw)
        return sample


class CenterCrop:

    def __init__(self, resize=224):
        self.resize = int(resize)

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        th = tw = self.resize
        y = max((h - th) // 2, 0)
        x = max((w - tw) // 2, 0)
        sample["image"] = image[y:y + th, x:x + tw]
        return sample


class Normalize:
    """image / 255 (no mean and std)."""

    def __call__(self, sample):
        sample["image"] = (sample["image"] / 255.0).astype(np.float32)
        return sample


class MeanStdNormalize:

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample):
        image = sample["image"].astype(np.float32) / 255.0
        sample["image"] = (image - self.mean) / self.std
        return sample


class RandomErasing:
    """timm-style random erasing: with ``prob``, one rectangle of area in
    ``area_range`` and log-uniform aspect, filled with normal noise
    (``mode="pixel"``) or zeros."""

    def __init__(self, prob=0.5, area_range=(0.02, 1. / 3.),
                 min_aspect_ratio=0.3, mode="pixel",
                 rng: random.Random | None = None,
                 np_rng: np.random.RandomState | None = None):
        self.prob = prob
        self.area_range = area_range
        self.log_aspect = (math.log(min_aspect_ratio),
                           math.log(1.0 / min_aspect_ratio))
        self.mode = mode
        self.rng = rng
        self.np_rng = np_rng

    def __call__(self, sample):
        if _py(self.rng).random() > self.prob:
            return sample
        image = sample["image"].astype(np.float32)
        h, w, c = image.shape
        rng = _py(self.rng)
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.area_range) * area
            aspect = math.exp(rng.uniform(*self.log_aspect))
            eh = int(round(math.sqrt(target * aspect)))
            ew = int(round(math.sqrt(target / aspect)))
            if eh < h and ew < w:
                y = rng.randint(0, h - eh)
                x = rng.randint(0, w - ew)
                if self.mode == "pixel":
                    image[y:y + eh, x:x + ew] = _np(self.np_rng).randn(
                        eh, ew, c).astype(np.float32)
                else:
                    image[y:y + eh, x:x + ew] = 0.0
                break
        sample["image"] = image
        return sample


class PCAJitter:
    """AlexNet-style PCA colour jitter."""

    def __init__(self, alpha_std=0.1,
                 np_rng: np.random.RandomState | None = None):
        self.alpha_std = alpha_std
        self.np_rng = np_rng

    def __call__(self, sample):
        image = sample["image"].astype(np.float32) / 255.0
        flat = image.reshape(-1, 3)
        cov = np.cov(flat, rowvar=False)
        eigval, eigvec = np.linalg.eigh(cov)
        alpha = _np(self.np_rng).normal(0, self.alpha_std, 3)
        delta = eigvec @ (alpha * eigval)
        sample["image"] = (image + delta) * 255.0
        return sample


# reference-name aliases (the configs use Torch* names)
TorchPad = Pad
TorchRandomHorizontalFlip = RandomHorizontalFlip
TorchRandomCrop = RandomCrop
TorchRandomResizedCrop = RandomResizedCrop
TorchResize = Resize
TorchCenterCrop = CenterCrop
TorchMeanStdNormalize = MeanStdNormalize
