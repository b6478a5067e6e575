"""FCOS (counterpart of ``simpleaicv_tpu/models/detection/fcos.py``): a
ResNet's C3-C5, ``RetinaFPN`` (P6 from P5) and the shared
``FCOSClsRegCntHead``, called once per level; each level's distances are
``reg * exp(scales[i])`` in f32, ``scales`` an f32 parameter of ones.
[B, H, W, 3] images -> [cls per level [B, h, w, C], reg per level
[B, h, w, 4], centerness per level [B, h, w, 1]], all f32.

``convformer_m36_fcos`` and ``van_b2_fcos`` take ConvFormer-M36's and
VAN-B2's last three stages in the ResNet's place."""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry import BACKBONES, MODELS
from .fpn import RetinaFPN
from .head import FCOSClsRegCntHead

__all__ = ["FCOS", "resnet18_fcos", "resnet34_fcos", "resnet50_fcos",
           "resnet101_fcos", "resnet152_fcos", "convformer_m36_fcos",
           "van_b2_fcos"]

LEVELS = 5


class FCOS(nn.Module):

    def __init__(self, backbone_type: str, planes: int = 256,
                 num_classes: int = 80, use_gn: bool = True,
                 cnt_on_reg: bool = True,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = RetinaFPN(self.backbone.feature_channels[-3:], planes,
                             use_p5=True, dtype=dtype)
        self.clsregcnt_head = FCOSClsRegCntHead(
            planes, num_classes, use_gn=use_gn, cnt_on_reg=cnt_on_reg,
            dtype=dtype)
        self.scales = nn.Parameter(torch.empty(LEVELS))

    def reset_parameters(self, generator):
        nn.init.ones_(self.scales)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        features = self.fpn(self.backbone(x, train)[-3:], train)
        cls_heads, reg_heads, center_heads = [], [], []
        for i, f in enumerate(features):
            cls, reg, cnt = self.clsregcnt_head(f)
            cls_heads.append(cls)
            reg_heads.append(reg.float() * torch.exp(self.scales[i]))
            center_heads.append(cnt)
        return [cls_heads, reg_heads, center_heads]


def _fcos(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return FCOS(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_fcos(**kwargs):
    return _fcos("resnet18", **kwargs)


@MODELS.register()
def resnet34_fcos(**kwargs):
    return _fcos("resnet34", **kwargs)


@MODELS.register()
def resnet50_fcos(**kwargs):
    return _fcos("resnet50", **kwargs)


@MODELS.register()
def resnet101_fcos(**kwargs):
    return _fcos("resnet101", **kwargs)


@MODELS.register()
def resnet152_fcos(**kwargs):
    return _fcos("resnet152", **kwargs)


@MODELS.register()
def convformer_m36_fcos(**kwargs):
    return _fcos("convformer_m36", **kwargs)


@MODELS.register()
def van_b2_fcos(**kwargs):
    return _fcos("van_b2", **kwargs)
