"""The readers that reuse another's layout (counterpart of
``simpleaicv_tpu/data/datasets/more_datasets.py``): Objects365 and
SAMA-COCO boxes in the COCO instances json, ACCV2022 a folder per
class."""

from .coco import CocoDetection
from .imagenet21k import ImageNet21KSingleLabelDataset

__all__ = ["Objects365Detection", "SamaCocoDetection", "ACCV2022Dataset"]


class Objects365Detection(CocoDetection):
    """The objects365_2020 json, laid out as COCO's instances json."""


class SamaCocoDetection(CocoDetection):
    """SAMA-COCO's relabelled set; its boxes share the COCO layout."""


class ACCV2022Dataset(ImageNet21KSingleLabelDataset):
    """ACCV2022's webly supervised classification set: a folder per
    class."""
