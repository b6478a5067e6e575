"""CelebA-HQ and FFHQ image folders for diffusion training (counterpart of
``simpleaicv_tpu/data/datasets/face_images.py``): the ``.jpg``,
``.jpeg`` and ``.png`` files of ``<root>/<set_name>/`` in sorted order,
each a sample {"image": [h, w, 3] f32 0..255 RGB, "label": -1};
``DiffusionNormalize`` maps the image to [-1, 1]."""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..image_io import read_image

__all__ = ["CelebAHQDataset", "FFHQDataset", "DiffusionNormalize"]


class _ImageFolder:

    def __init__(self, image_dir: str, transform: Optional[Callable] = None):
        self.image_dir = image_dir
        self.transform = transform
        self._files = None

    def _scan(self):
        if self._files is None:
            self._files = sorted(
                os.path.join(self.image_dir, f)
                for f in os.listdir(self.image_dir)
                if f.lower().endswith((".jpg", ".jpeg", ".png")))

    def __len__(self):
        self._scan()
        return len(self._files)

    def __getitem__(self, idx):
        self._scan()
        sample = {"image": read_image(self._files[idx]).astype(np.float32),
                  "label": -1}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class CelebAHQDataset(_ImageFolder):

    def __init__(self, root_dir: str, set_name: str = "train",
                 transform: Optional[Callable] = None):
        super().__init__(os.path.join(root_dir, set_name), transform)


class FFHQDataset(_ImageFolder):

    def __init__(self, root_dir: str, set_name: str = "training",
                 transform: Optional[Callable] = None):
        super().__init__(os.path.join(root_dir, set_name), transform)


class DiffusionNormalize:
    """x in [0, 255] -> x / 127.5 - 1 in f32."""

    def __call__(self, sample):
        sample["image"] = (sample["image"] / 127.5 - 1.0).astype(np.float32)
        return sample
