"""Synthetic classification datasets (counterpart of part of
``simpleaicv_tpu/data/datasets/synthetic.py``), numpy only. Sample ``idx``
holds the same arrays as the JAX package's."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["FakeClassificationDataset", "LearnableClassificationDataset"]


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
