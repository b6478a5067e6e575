"""DeepLabV3+ (counterpart of
``simpleaicv_tpu/models/segmentation/deeplabv3plus.py``): an ASPP head on
each of the backbone's four stages (C1-C4 in the JAX package's naming), the
three coarser ones resized to C1's size (align-corners bilinear), fused by
two depthwise-separable convolutions, 1x1 logits in f32, and the logits
resized to the input's size.

NHWC. Convolutions compute in ``dtype`` from f32 parameters. The head's
``ConvBnAct`` is the JAX model's own: flax's ``nn.BatchNorm``
(``models.common.BatchNorm``), not the backbone's ``ops.fused_bn``. Its
depthwise 3x3 convolutions are dilated by 12, 24 and 36 (output stride 8)
or 6, 12 and 18, padded by ``dilation * (k - 1) // 2``. State-dict keys are
the JAX paths: ``backbone.layer1.0.conv1.conv``,
``head.aspp2.aspp1.dw.conv``, ``head.fuse_conv_0.pw.bn``,
``head.predict_conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES, MODELS
from ..common import BatchNorm, Conv2d, recomputing
from ..detection.fpn import _upsample_to

__all__ = ["DeepLabV3Plus", "resnet18_deeplabv3plus", "resnet34_deeplabv3plus",
           "resnet50_deeplabv3plus", "resnet101_deeplabv3plus",
           "resnet152_deeplabv3plus", "vanb2_deeplabv3plus",
           "convformerm36_deeplabv3plus"]


class ConvBnAct(nn.Module):
    """conv (no bias) -> flax BatchNorm in f32 -> ReLU in ``dtype``; with
    ``depthwise`` one filter per input channel and ``planes`` ignored."""

    def __init__(self, in_planes: int, planes: int, kernel_size: int = 1,
                 dilation: int = 1, depthwise: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        groups = in_planes if depthwise else 1
        planes = in_planes if depthwise else planes
        self.conv = Conv2d(in_planes, planes, kernel_size,
                           padding=dilation * (kernel_size - 1) // 2,
                           bias=False, dtype=dtype, dilation=dilation,
                           groups=groups)
        self.bn = BatchNorm(planes)
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train, update_stats=not recomputing())
        return F.relu(x.to(self.dtype))


class LightConv(nn.Module):
    """Depthwise kxk dilated + pointwise 1x1."""

    def __init__(self, in_planes: int, planes: int, kernel_size: int = 3,
                 dilation: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dw = ConvBnAct(in_planes, in_planes, kernel_size, dilation,
                            depthwise=True, dtype=dtype)
        self.pw = ConvBnAct(in_planes, planes, 1, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.pw(self.dw(x, train), train)


class ASPPBlock(nn.Module):

    def __init__(self, in_planes: int, planes: int = 256,
                 output_stride: int = 8, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        d = (12, 24, 36) if output_stride == 8 else (6, 12, 18)
        self.pooling_conv = ConvBnAct(in_planes, planes, 1, dtype=dtype)
        self.aspp0 = ConvBnAct(in_planes, planes, 1, dtype=dtype)
        self.aspp1 = LightConv(in_planes, planes, 3, d[0], dtype)
        self.aspp2 = LightConv(in_planes, planes, 3, d[1], dtype)
        self.aspp3 = LightConv(in_planes, planes, 3, d[2], dtype)
        self.fuse_conv = ConvBnAct(5 * planes, planes, 1, dtype=dtype)
        self.planes, self.dtype = planes, dtype

    def forward(self, x, train: bool = False):
        b, h, w, _ = x.shape
        pool = x.float().mean(dim=(1, 2), keepdim=True)
        pool = self.pooling_conv(pool.to(self.dtype), train)
        pool = pool.expand(b, h, w, self.planes)
        x = torch.cat([pool, self.aspp0(x, train), self.aspp1(x, train),
                       self.aspp2(x, train), self.aspp3(x, train)], dim=-1)
        return self.fuse_conv(x, train)


class DeepLabV3PlusHead(nn.Module):

    def __init__(self, in_channels, planes: int = 256,
                 output_stride: int = 8, num_classes: int = 150,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"aspp{i + 1}",
                            ASPPBlock(c, planes, output_stride, dtype))
        self.fuse_conv_0 = LightConv(len(in_channels) * planes, planes, 3, 1,
                                     dtype)
        self.fuse_conv_1 = LightConv(planes, planes, 3, 1, dtype)
        self.predict_conv = Conv2d(planes, num_classes, 1, bias=True,
                                   dtype=torch.float32)

    def forward(self, features, train: bool = False):
        h, w = features[0].shape[1], features[0].shape[2]
        outs = []
        for i, c in enumerate(features):
            a = getattr(self, f"aspp{i + 1}")(c, train)
            outs.append(_upsample_to(a, h, w) if i > 0 else a)
        x = torch.cat(outs, dim=-1)
        x = self.fuse_conv_1(self.fuse_conv_0(x, train), train)
        return self.predict_conv(x.float())


class DeepLabV3Plus(nn.Module):
    """[B, H, W, 3] images -> [B, H, W, num_classes] f32 logits."""

    def __init__(self, backbone_type: str, planes: int = 256,
                 output_stride: int = 8, num_classes: int = 150,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.head = DeepLabV3PlusHead(self.backbone.feature_channels, planes,
                                      output_stride, num_classes, dtype)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        h, w = x.shape[1], x.shape[2]
        logits = self.head(self.backbone(x, train), train)
        return _upsample_to(logits, h, w)


def _deeplab(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return DeepLabV3Plus(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_deeplabv3plus(**kwargs):
    return _deeplab("resnet18", **kwargs)


@MODELS.register()
def resnet34_deeplabv3plus(**kwargs):
    return _deeplab("resnet34", **kwargs)


@MODELS.register()
def resnet50_deeplabv3plus(**kwargs):
    return _deeplab("resnet50", **kwargs)


@MODELS.register()
def resnet101_deeplabv3plus(**kwargs):
    return _deeplab("resnet101", **kwargs)


@MODELS.register()
def resnet152_deeplabv3plus(**kwargs):
    return _deeplab("resnet152", **kwargs)


@MODELS.register()
def vanb2_deeplabv3plus(**kwargs):
    return _deeplab("van_b2", **kwargs)


@MODELS.register()
def convformerm36_deeplabv3plus(**kwargs):
    return _deeplab("convformer_m36", **kwargs)
