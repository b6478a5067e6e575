"""Datasets of the PyTorch port (numpy; JPEG files through the port's
libjpeg binding)."""

from .cifar import CIFAR10Dataset, CIFAR100Dataset  # noqa: F401
from .coco import FakeDetectionDataset  # noqa: F401
from .ilsvrc2012 import ILSVRC2012Dataset  # noqa: F401
from .imagenet21k import (ImageNet21KSemanticCollater,  # noqa: F401
                          ImageNet21KSemanticTreeLabelDataset,
                          ImageNet21KSingleLabelDataset)
from .synthetic import (FakeClassificationDataset,  # noqa: F401
                        LearnableClassificationDataset,
                        LearnableDetectionDataset, TwoModeImageDataset)
