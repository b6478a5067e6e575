"""RetinaNet (counterpart of ``simpleaicv_tpu/models/detection/retinanet.py``):
a ResNet's C3-C5, ``RetinaFPN`` (P6 from C5) and the shared classification
and regression towers, called once per level. [B, H, W, 3] images -> [cls
per level [B, h, w, A, C] f32 probabilities, reg per level [B, h, w, A, 4]
in ``dtype``]."""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry import BACKBONES, MODELS
from .fpn import RetinaFPN
from .head import RetinaClsHead, RetinaRegHead

__all__ = ["RetinaNet", "resnet18_retinanet", "resnet34_retinanet",
           "resnet50_retinanet", "resnet101_retinanet", "resnet152_retinanet"]


class RetinaNet(nn.Module):

    def __init__(self, backbone_type: str, planes: int = 256,
                 num_anchors: int = 9, num_classes: int = 80,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_anchors, self.num_classes = num_anchors, num_classes
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = RetinaFPN(self.backbone.feature_channels[-3:], planes,
                             dtype=dtype)
        self.cls_head = RetinaClsHead(planes, num_anchors, num_classes,
                                      dtype=dtype)
        self.reg_head = RetinaRegHead(planes, num_anchors, dtype=dtype)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        features = self.fpn(self.backbone(x, train)[-3:], train)
        cls_heads, reg_heads = [], []
        for f in features:
            b, h, w, _ = f.shape
            cls_heads.append(self.cls_head(f).reshape(
                b, h, w, self.num_anchors, self.num_classes))
            reg_heads.append(self.reg_head(f).reshape(
                b, h, w, self.num_anchors, 4))
        return [cls_heads, reg_heads]


def _retinanet(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return RetinaNet(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_retinanet(**kwargs):
    return _retinanet("resnet18", **kwargs)


@MODELS.register()
def resnet34_retinanet(**kwargs):
    return _retinanet("resnet34", **kwargs)


@MODELS.register()
def resnet50_retinanet(**kwargs):
    return _retinanet("resnet50", **kwargs)


@MODELS.register()
def resnet101_retinanet(**kwargs):
    return _retinanet("resnet101", **kwargs)


@MODELS.register()
def resnet152_retinanet(**kwargs):
    return _retinanet("resnet152", **kwargs)
