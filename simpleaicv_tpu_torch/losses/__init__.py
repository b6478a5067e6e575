"""Losses of the PyTorch port (importing it registers them)."""

from .classification import (CELoss, FocalCELoss, LabelSmoothCELoss,
                             OneHotLabelCELoss, SemanticSoftmaxLoss)  # noqa: F401
from .dinodetr import DINODETRLoss  # noqa: F401
from .interactive_segmentation import (  # noqa: F401
    SAMDistillLoss, SAMDistillMSELoss, SAMMultiLevelAssignLoss,
    SAMMultiLevelIoUMaxLoss, SAMMultiLevelLoss)
