"""SOLOv2 (counterpart of
``simpleaicv_tpu/models/instance_segmentation/solov2.py``): a ResNet's
C2-C5, ``SOLOV2FPN`` (P2-P5 by 1x1 laterals, align-corners top-down adds and
3x3 convolutions; P6 a stride-2 slice of P5), the mask-feature head over
P2-P5 (coordinate channels on the deepest level) and the kernel and
category heads over the five levels, each resized to its S x S grid.

The kernel and category towers are one set of modules called on every
level. ``ConvGnAct`` is a convolution without bias in ``dtype``, flax's
GroupNorm(32) in f32 and a cast back to ``dtype`` before the ReLU. The
category prediction is an f32 convolution from a normal(0.01) kernel and
the prior bias; the kernel predictions are cast to f32.
[B, H, W, 3] images -> (mask features [B, H/4, W/4, C] in ``dtype``,
kernels per level [B, S, S, 256] f32, category logits per level
[B, S, S, num_classes] f32). NHWC; state-dict keys are the JAX paths with
``_N`` written ``.N``.

``vanb2_solov2`` and ``convformerm36_solov2`` take VAN-B2's and
ConvFormer-M36's four stages in the ResNet's place.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES, MODELS
from ..common import Conv2d, GroupNorm
from ..detection.fpn import _upsample_to
from ..detection.head import PRIOR_BIAS

__all__ = ["SOLOV2", "ConvGnAct", "coord_features", "resnet18_solov2",
           "resnet34_solov2", "resnet50_solov2", "resnet101_solov2",
           "resnet152_solov2", "vanb2_solov2", "convformerm36_solov2"]


def _conv(in_planes, planes, k=3, bias=True, dtype=torch.bfloat16):
    return Conv2d(in_planes, planes, k, padding=(k - 1) // 2, bias=bias,
                  dtype=dtype)


class ConvGnAct(nn.Module):

    def __init__(self, in_planes: int, planes: int, kernel_size: int = 3,
                 has_act: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = _conv(in_planes, planes, kernel_size, bias=False,
                          dtype=dtype)
        self.gn = GroupNorm(32, planes)
        self.has_act, self.dtype = has_act, dtype

    def forward(self, x):
        x = self.gn(self.conv(x)).to(self.dtype)
        return F.relu(x) if self.has_act else x


def coord_features(x):
    """x [B, H, W, C] with two channels appended: the x and y coordinates,
    each ``linspace(-1, 1)`` over its axis, in x's dtype."""
    b, h, w, _ = x.shape
    ys = torch.linspace(-1.0, 1.0, h, device=x.device)
    xs = torch.linspace(-1.0, 1.0, w, device=x.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coord = torch.stack([gx, gy], dim=-1)[None].expand(b, h, w, 2)
    return torch.cat([x, coord.to(x.dtype)], dim=-1)


class SOLOV2FPN(nn.Module):
    """(C2, C3, C4, C5) -> [P2, P3, P4, P5, P6]."""

    def __init__(self, in_channels: Sequence[int], planes: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.lateral = nn.ModuleList(_conv(c, planes, 1, dtype=dtype)
                                     for c in in_channels)
        self.fpn = nn.ModuleList(_conv(planes, planes, 3, dtype=dtype)
                                 for _ in in_channels)

    def forward(self, inputs, train: bool = False):
        laterals = [conv(c) for conv, c in zip(self.lateral, inputs)]
        for i in range(len(inputs) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_to(
                laterals[i], laterals[i - 1].shape[1],
                laterals[i - 1].shape[2])
        outs = [conv(x) for conv, x in zip(self.fpn, laterals)]
        outs.append(outs[-1][:, ::2, ::2, :])  # a stride-2 1x1 max pool
        return outs


class SOLOV2MaskFeatHead(nn.Module):
    """[P2, P3, P4, P5] -> mask features at P2's size."""

    def __init__(self, in_planes: int, planes: int = 128,
                 num_classes: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.level_0_conv1 = ConvGnAct(in_planes, planes, dtype=dtype)
        self.level_1_conv1 = ConvGnAct(in_planes, planes, dtype=dtype)
        self.level_2_conv1 = ConvGnAct(in_planes, planes, dtype=dtype)
        self.level_2_conv2 = ConvGnAct(planes, planes, dtype=dtype)
        self.level_3_conv1 = ConvGnAct(in_planes + 2, planes, dtype=dtype)
        self.level_3_conv2 = ConvGnAct(planes, planes, dtype=dtype)
        self.level_3_conv3 = ConvGnAct(planes, planes, dtype=dtype)
        self.pred_conv = ConvGnAct(planes, num_classes, 1, dtype=dtype)

    def forward(self, inputs):
        h0, w0 = inputs[0].shape[1], inputs[0].shape[2]
        sizes = [(x.shape[1], x.shape[2]) for x in inputs]
        fused = self.level_0_conv1(inputs[0])
        fused = fused + _upsample_to(self.level_1_conv1(inputs[1]), h0, w0)
        x2 = _upsample_to(self.level_2_conv1(inputs[2]), *sizes[1])
        fused = fused + _upsample_to(self.level_2_conv2(x2), h0, w0)
        x3 = self.level_3_conv1(coord_features(inputs[3]))
        x3 = self.level_3_conv2(_upsample_to(x3, *sizes[2]))
        x3 = self.level_3_conv3(_upsample_to(x3, *sizes[1]))
        fused = fused + _upsample_to(x3, h0, w0)
        return self.pred_conv(fused)


class SOLOV2BboxHead(nn.Module):
    """[P2, ..., P6] -> (kernels per level, category logits per level);
    P2 is first resized to P3's size and P6 to P5's."""

    def __init__(self, in_planes: int, inter_planes: int = 512,
                 instance_planes: int = 256, stacked_conv_nums: int = 4,
                 grid_nums: Sequence[int] = (40, 36, 24, 16, 12),
                 num_classes: int = 80, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.grid_nums = tuple(grid_nums)
        self.kernel_conv = nn.ModuleList(
            ConvGnAct(in_planes + 2 if j == 0 else inter_planes,
                      inter_planes, dtype=dtype)
            for j in range(stacked_conv_nums))
        self.cate_conv = nn.ModuleList(
            ConvGnAct(in_planes if j == 0 else inter_planes, inter_planes,
                      dtype=dtype) for j in range(stacked_conv_nums))
        self.kernel_pred_conv = _conv(inter_planes, instance_planes, 3,
                                      dtype=dtype)
        self.cate_pred_conv = Conv2d(inter_planes, num_classes, 3, padding=1,
                                     dtype=torch.float32, normal_std=0.01,
                                     bias_fill=PRIOR_BIAS)

    def forward(self, inputs):
        p2, p3, p4, p5, p6 = inputs
        p2 = _upsample_to(p2, p3.shape[1], p3.shape[2])
        p6 = _upsample_to(p6, p5.shape[1], p5.shape[2])
        kernel_preds, cate_preds = [], []
        for g, f in zip(self.grid_nums, (p2, p3, p4, p5, p6)):
            kf = _upsample_to(coord_features(f), g, g)
            cf = kf[..., :-2]
            for kernel_conv, cate_conv in zip(self.kernel_conv,
                                              self.cate_conv):
                kf = kernel_conv(kf)
                cf = cate_conv(cf)
            kernel_preds.append(self.kernel_pred_conv(kf).float())
            cate_preds.append(self.cate_pred_conv(cf.float()))
        return kernel_preds, cate_preds


class SOLOV2(nn.Module):

    def __init__(self, backbone_type: str, fpn_planes: int = 256,
                 mask_feature_planes: int = 128,
                 mask_feature_num_classes: int = 256,
                 bbox_inter_planes: int = 512, instance_planes: int = 256,
                 grid_nums: Sequence[int] = (40, 36, 24, 16, 12),
                 num_classes: int = 80, use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = SOLOV2FPN(self.backbone.feature_channels, fpn_planes,
                             dtype=dtype)
        self.mask_feature_head = SOLOV2MaskFeatHead(
            fpn_planes, mask_feature_planes, mask_feature_num_classes,
            dtype=dtype)
        self.bbox_head = SOLOV2BboxHead(
            fpn_planes, bbox_inter_planes, instance_planes,
            grid_nums=grid_nums, num_classes=num_classes, dtype=dtype)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        feats = self.fpn(self.backbone(x, train), train)
        mask_feat = self.mask_feature_head(feats[0:4])
        kernel_preds, cate_preds = self.bbox_head(feats)
        return mask_feat, kernel_preds, cate_preds


def _solov2(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return SOLOV2(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_solov2(**kwargs):
    return _solov2("resnet18", **kwargs)


@MODELS.register()
def resnet34_solov2(**kwargs):
    return _solov2("resnet34", **kwargs)


@MODELS.register()
def resnet50_solov2(**kwargs):
    return _solov2("resnet50", **kwargs)


@MODELS.register()
def resnet101_solov2(**kwargs):
    return _solov2("resnet101", **kwargs)


@MODELS.register()
def resnet152_solov2(**kwargs):
    return _solov2("resnet152", **kwargs)


@MODELS.register()
def vanb2_solov2(**kwargs):
    return _solov2("van_b2", **kwargs)


@MODELS.register()
def convformerm36_solov2(**kwargs):
    return _solov2("convformer_m36", **kwargs)
