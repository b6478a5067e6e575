"""Losses of the PyTorch port (importing it registers them)."""

from .classification import (CELoss, FocalCELoss, LabelSmoothCELoss,
                             OneHotLabelCELoss, SemanticSoftmaxLoss)  # noqa: F401
from .detection import FCOSLoss, RetinaLoss  # noqa: F401
from .detr import DETRLoss  # noqa: F401
from .dinodetr import DINODETRLoss  # noqa: F401
from .instance_segmentation import SOLOV2Loss  # noqa: F401
from .yolact import YOLACTLoss  # noqa: F401
from .interactive_segmentation import (  # noqa: F401
    SAMDistillLoss, SAMDistillMSELoss, SAMMultiLevelAssignLoss,
    SAMMultiLevelIoUMaxLoss, SAMMultiLevelLoss)
from .segmentation import (SegCELoss, SegCombinedLoss,  # noqa: F401
                           SegDiceLoss, SegIoULoss, SegLovaszLoss,
                           SegMultiClassBCELoss)
from .binary_segmentation import (BCEDiceLoss, BCEIouloss,  # noqa: F401
                                  BinaryBCELoss, OHEMBCELoss)
from .distillation import DMLLoss, KDLoss, L2Loss  # noqa: F401
from .mae import MAEL1Loss, MAEMSELoss  # noqa: F401
from .matting import (CompositionLoss, FusionAlphaLoss,  # noqa: F401
                      FusionLaplacianLoss, GloabelTrimapIouLoss,
                      GlobalTrimapCELoss, LocalAlphaLoss, LocalLaplacianLoss)
from .text_detection import DBNetLoss  # noqa: F401
from .text_recognition import ACELoss, CTCLoss  # noqa: F401
from .sam_matting import (SAMMattingMultiLevelAssignLoss,  # noqa: F401
                          SAMMattingMultiLevelIoUMaxLoss,
                          SAMMattingMultiLevelLoss, SAMMattingOneLevelLoss)
