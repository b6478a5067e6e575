"""Datasets of the PyTorch port (numpy only)."""

from .coco import FakeDetectionDataset  # noqa: F401
