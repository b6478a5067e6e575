"""Datasets of the PyTorch port (numpy; every name of the JAX package's
``data/datasets``). Images decode through ``data/image_io.py`` (PIL, to
OpenCV's pixels) or, in the ImageNet readers, the port's libjpeg
binding first."""

from .cifar import CIFAR10Dataset, CIFAR100Dataset  # noqa: F401
from .synthetic import (FakeClassificationDataset,  # noqa: F401
                        LearnableClassificationDataset,
                        LearnableDetectionDataset, TwoModeImageDataset)
from .ilsvrc2012 import ILSVRC2012Dataset  # noqa: F401
from .coco import CocoDetection, FakeDetectionDataset  # noqa: F401
from .voc import VocDetection, evaluate_voc_detection  # noqa: F401
from .ade20k import ADE20KDataset  # noqa: F401
from .face_images import CelebAHQDataset, FFHQDataset  # noqa: F401
from .combined_folder import (SalientObjectDetectionDataset,  # noqa: F401
                              HumanMattingDataset, HumanParsingDataset,
                              FaceParsingDataset, FaceDetectionDataset)
from .imagenet21k import (ImageNet21KSingleLabelDataset,  # noqa: F401
                          ImageNet21KSemanticTreeLabelDataset,
                          ImageNet21KSemanticCollater)
from .text import TextDetection, TextRecognition  # noqa: F401
from .sam_segmentation import SAMSegmentationDataset  # noqa: F401
from .more_datasets import (Objects365Detection,  # noqa: F401
                            SamaCocoDetection, ACCV2022Dataset)
from .coco_instance import CocoInstanceSegmentation  # noqa: F401
from .coco_semantic import CocoSemanticSegmentation  # noqa: F401
