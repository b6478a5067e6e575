"""CIFAR-10 and CIFAR-100 (counterpart of
``simpleaicv_tpu/data/datasets/cifar.py``): the standard python-pickle
batch files, read at the first access (nothing touches the disk when the
dataset is built); samples {"image": [32, 32, 3] f32 0..255, "label": int}.
Nothing is decoded. The pickles are the dataset's own files, loaded as the
reference loads them."""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np

__all__ = ["CIFAR10Dataset", "CIFAR100Dataset"]


class _CifarBase:
    n_classes = 0
    train_files: list = []
    test_files: list = []
    label_key = b"labels"
    subdir = ""

    def __init__(self, root_dir: str, set_name: str = "train",
                 transform: Optional[Callable] = None):
        self.root_dir = root_dir
        self.set_name = set_name
        self.transform = transform
        self._images = None
        self._labels = None

    def _load(self):
        if self._images is not None:
            return
        files = (self.train_files if self.set_name == "train"
                 else self.test_files)
        images, labels = [], []
        for fname in files:
            path = os.path.join(self.root_dir, self.subdir, fname)
            with open(path, "rb") as f:
                entry = pickle.load(f, encoding="bytes")
            images.append(entry[b"data"].reshape(-1, 3, 32, 32)
                          .transpose(0, 2, 3, 1))
            labels.extend(entry[self.label_key])
        self._images = np.concatenate(images)
        self._labels = np.asarray(labels, np.int64)

    def __len__(self):
        self._load()
        return len(self._labels)

    def __getitem__(self, idx):
        self._load()
        sample = {"image": self._images[idx].astype(np.float32),
                  "label": int(self._labels[idx])}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class CIFAR10Dataset(_CifarBase):
    n_classes = 10
    subdir = "cifar-10-batches-py"
    train_files = [f"data_batch_{i}" for i in range(1, 6)]
    test_files = ["test_batch"]
    label_key = b"labels"


class CIFAR100Dataset(_CifarBase):
    n_classes = 100
    subdir = "cifar-100-python"
    train_files = ["train"]
    test_files = ["test"]
    label_key = b"fine_labels"
