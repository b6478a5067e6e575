"""Synthetic classification, detection and diffusion datasets (counterpart
of part of ``simpleaicv_tpu/data/datasets/synthetic.py``), numpy only.
Sample ``idx`` holds the same arrays as the JAX package's."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["FakeClassificationDataset", "LearnableClassificationDataset",
           "LearnableDetectionDataset", "TwoModeImageDataset"]


class FakeClassificationDataset:
    """A random image in 0..255 (f32, ``image_hw`` square) and a random
    label, both drawn from ``np.random.RandomState(idx)``: nothing to
    learn."""

    def __init__(self, num_samples: int = 512, image_hw: int = 32,
                 num_classes: int = 100,
                 transform: Optional[Callable] = None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        sample = {
            "image": rng.randint(
                0, 256, (self.image_hw, self.image_hw, 3)).astype(np.float32),
            "label": int(rng.randint(0, self.num_classes)),
        }
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class LearnableClassificationDataset:
    """A separable task: class ``idx % num_classes`` is a fixed random
    template in [64, 192] plus per-sample Gaussian noise (``noise`` pixels),
    clipped to [0, 255]. ``set_name`` other than "train" offsets the noise
    seeds, so train and val draws are disjoint and share the templates."""

    def __init__(self, num_samples: int = 256, image_hw: int = 32,
                 num_classes: int = 4, noise: float = 20.0,
                 set_name: str = "train",
                 transform: Optional[Callable] = None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.noise = noise
        self.seed_base = 0 if set_name == "train" else 1_000_003
        self.transform = transform
        self.templates = [
            64.0 + 128.0 * np.random.RandomState(7 + c).rand(
                image_hw, image_hw, 3).astype(np.float32)
            for c in range(num_classes)]

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        label = idx % self.num_classes
        rng = np.random.RandomState(self.seed_base + idx)
        image = self.templates[label] + self.noise * rng.randn(
            self.image_hw, self.image_hw, 3).astype(np.float32)
        sample = {"image": np.clip(image, 0.0, 255.0), "label": int(label)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class LearnableDetectionDataset:
    """A separable detection task: one pure-colour rectangle (sides
    ``image_hw`` / 4 to / 2) on dim noise, the class its colour channel (3
    classes), drawn from ``np.random.RandomState(seed_base + idx)``. Every
    box is wholly visible, so a small detector learns it in a few hundred
    steps. ``set_name`` other than "train" offsets the seeds, so train and
    val draws are disjoint."""

    def __init__(self, num_samples: int = 64, image_hw: int = 96,
                 set_name: str = "train",
                 transform: Optional[Callable] = None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.num_classes = 3
        self.seed_base = 0 if set_name == "train" else 1_000_003
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed_base + idx)
        hw = self.image_hw
        image = rng.uniform(0, 60, (hw, hw, 3)).astype(np.float32)
        w = rng.randint(hw // 4, hw // 2)
        h = rng.randint(hw // 4, hw // 2)
        x1 = rng.randint(0, hw - w)
        y1 = rng.randint(0, hw - h)
        cls = rng.randint(0, 3)
        color = np.zeros(3, np.float32)
        color[cls] = 230.0
        image[y1:y1 + h, x1:x1 + w] = color
        sample = {"image": image,
                  "annots": np.asarray([[x1, y1, x1 + w, y1 + h, cls]],
                                       np.float32),
                  "scale": np.float32(1.0),
                  "size": np.array([hw, hw], np.float32),
                  "image_id": idx}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class TwoModeImageDataset:
    """A two-mode toy distribution for diffusion: sample ``idx`` is a
    constant image at pixel level ``(+-mode + 1) * 127.5`` (the sign
    alternating with ``idx``) plus Gaussian noise of 4 levels from
    ``np.random.RandomState(idx)``, clipped to [0, 255]. A DDPM that learns
    the distribution samples both modes."""

    def __init__(self, num_samples: int = 64, image_hw: int = 16,
                 mode: float = 0.6):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.mode = mode

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        sign = 1.0 if idx % 2 == 0 else -1.0
        base = (sign * self.mode + 1.0) * 127.5
        img = base + 4.0 * rng.randn(self.image_hw, self.image_hw, 3)
        return {"image": np.clip(img, 0, 255).astype(np.float32),
                "label": 0}
