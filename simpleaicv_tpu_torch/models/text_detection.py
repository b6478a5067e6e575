"""DBNet text detection (counterpart of
``simpleaicv_tpu/models/text_detection.py``): a ResNet's C2-C5, ``DBNetFPN``
(1x1 laterals to inter_planes / 4 channels, align-corners top-down adds
and 3x3 convolutions, the four levels resized to C2's size, concatenated
and fused by a 3x3 convolution) and ``DBNetHead``: two ``_UpHead``s (3x3
conv, then two 2x2 stride-2 transposed convolutions back to the input's
size, a sigmoid in f32), the probability and the threshold map.

``ConvBnAct`` is the backbone's (``ops.fused_bn``); ``_UpHead``'s
BatchNorm is flax's (``models.common.BatchNorm``: unshifted, the biased
variance). The first transposed convolution computes in ``dtype``, the
second in f32. [B, H, W, 3] images -> [B, H, W, 2] f32 (probability,
threshold). NHWC; state-dict keys are the JAX paths (``fpn.c5_conv``,
``head.binary_conv.convt1``).

``vanb2_dbnet`` and ``convformerm36_dbnet`` take VAN-B2's and
ConvFormer-M36's four stages in the ResNet's place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import BACKBONES, MODELS
from .common import BatchNorm, ConvBnAct, ConvTranspose2d, recomputing
from .detection.fpn import _upsample_to

__all__ = ["DBNet", "DBNetFPN", "DBNetHead", "resnet18_dbnet",
           "resnet34_dbnet", "resnet50_dbnet", "vanb2_dbnet",
           "convformerm36_dbnet"]


class DBNetFPN(nn.Module):

    def __init__(self, in_channels, inter_planes: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        q = inter_planes // 4
        for name, c in (("c5_conv", c5), ("c4_conv", c4), ("c3_conv", c3),
                        ("c2_conv", c2)):
            self.add_module(name, ConvBnAct(c, q, 1, dtype=dtype))
        for name in ("p4_conv", "p3_conv", "p2_conv"):
            self.add_module(name, ConvBnAct(q, q, 3, dtype=dtype))
        self.last_conv = ConvBnAct(4 * q, inter_planes, 3, dtype=dtype)

    def forward(self, features, train: bool = False):
        c2, c3, c4, c5 = features
        p5 = self.c5_conv(c5, train)
        p4 = self.c4_conv(c4, train)
        p4 = self.p4_conv(_upsample_to(p5, p4.shape[1], p4.shape[2]) + p4,
                          train)
        p3 = self.c3_conv(c3, train)
        p3 = self.p3_conv(_upsample_to(p4, p3.shape[1], p3.shape[2]) + p3,
                          train)
        p2 = self.c2_conv(c2, train)
        p2 = self.p2_conv(_upsample_to(p3, p2.shape[1], p2.shape[2]) + p2,
                          train)
        h, w = p2.shape[1], p2.shape[2]
        fused = torch.cat([p2, _upsample_to(p3, h, w), _upsample_to(p4, h, w),
                           _upsample_to(p5, h, w)], dim=-1)
        return self.last_conv(fused, train)


class _UpHead(nn.Module):
    """3x3 conv -> convT/2 -> flax BatchNorm -> ReLU -> convT/2 to one
    channel -> sigmoid in f32."""

    def __init__(self, in_planes: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        q = in_planes // 4
        self.conv = ConvBnAct(in_planes, q, 3, dtype=dtype)
        self.convt1 = ConvTranspose2d(q, q, 2, 2, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(q)
        self.convt2 = ConvTranspose2d(q, 1, 2, 2, bias=True,
                                      dtype=torch.float32)
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        x = self.conv(x, train)
        x = self.bn1(self.convt1(x), train, update_stats=not recomputing())
        x = F.relu(x.to(self.dtype))
        return torch.sigmoid(self.convt2(x).float())


class DBNetHead(nn.Module):

    def __init__(self, in_planes: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.binary_conv = _UpHead(in_planes, dtype)
        self.thresh_conv = _UpHead(in_planes, dtype)

    def forward(self, x, train: bool = False):
        return torch.cat([self.binary_conv(x, train),
                          self.thresh_conv(x, train)], dim=-1)


class DBNet(nn.Module):
    """[B, H, W, 3] images (H, W multiples of 32) -> [B, H, W, 2] f32
    (probability, threshold) maps. ``k`` (the differentiable binarisation's
    slope) belongs to the loss; it is kept for the JAX model's surface."""

    def __init__(self, backbone_type: str, inter_planes: int = 256,
                 k: int = 50, use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.k = k
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = DBNetFPN(self.backbone.feature_channels, inter_planes,
                            dtype)
        self.head = DBNetHead(inter_planes, dtype)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        return self.head(self.fpn(self.backbone(x, train), train), train)


def _dbnet(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return DBNet(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_dbnet(**kwargs):
    return _dbnet("resnet18", **kwargs)


@MODELS.register()
def resnet34_dbnet(**kwargs):
    return _dbnet("resnet34", **kwargs)


@MODELS.register()
def resnet50_dbnet(**kwargs):
    return _dbnet("resnet50", **kwargs)


@MODELS.register()
def vanb2_dbnet(**kwargs):
    return _dbnet("van_b2", **kwargs)


@MODELS.register()
def convformerm36_dbnet(**kwargs):
    return _dbnet("convformer_m36", **kwargs)
