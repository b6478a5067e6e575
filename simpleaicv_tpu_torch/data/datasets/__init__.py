"""Datasets of the PyTorch port (numpy only)."""

from .coco import FakeDetectionDataset  # noqa: F401
from .synthetic import (FakeClassificationDataset,  # noqa: F401
                        LearnableClassificationDataset)
