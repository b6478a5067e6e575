"""YOLACT (counterpart of
``simpleaicv_tpu/models/instance_segmentation/yolact.py``): a ResNet's
C3-C5, ``YOLACTFPN`` (P3-P7), ``ProtoNet`` (prototypes at C2's size), the
head shared by the five levels (per anchor: class logits with background
at 0, box offsets and tanh mask coefficients) and the f32 semantic
segmentation convolution on P3.

Every convolution but the semantic one computes in ``dtype`` from a
normal(0.01) kernel and a zero bias; the head's outputs and the prototypes
are cast to f32. [B, H, W, 3] images -> (class logits per level
[B, h, w, 3, num_classes], boxes per level [B, h, w, 3, 4], coefficients
per level [B, h, w, 3, 32], prototypes [B, H/4, W/4, 32], semantic logits
[B, H/8, W/8, num_classes - 1]), all f32. NHWC; state-dict keys are the
JAX paths with ``_N`` written ``.N``. ``YOLACTAnchors`` is numpy.

``vanb2_yolact`` and ``convformerm36_yolact`` take VAN-B2's and
ConvFormer-M36's stages in the ResNet's place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES, MODELS
from ..common import Conv2d
from ..detection.fpn import _upsample_to

__all__ = ["YOLACT", "YOLACTAnchors", "resnet18_yolact", "resnet34_yolact",
           "resnet50_yolact", "resnet101_yolact", "resnet152_yolact",
           "vanb2_yolact", "convformerm36_yolact"]


class YOLACTAnchors:
    """Relative [cx, cy, w, h] anchors in [0, 1] (YOLACT's SSD-style prior
    format); the scales are rescaled by resize / 544."""

    def __init__(self, resize=544, scales=(24, 48, 96, 192, 384),
                 ratios=(1, 0.5, 2), strides=(8, 16, 32, 64, 128)):
        self.resize = resize
        self.scales = resize / 544.0 * np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.strides = np.asarray(strides, np.float32)

    def flat_anchors(self, fpn_feature_sizes):
        """[sum(h * w * A), 4] relative cxcywh; each size is [w, h]."""
        out = []
        for scale, fm in zip(self.scales, fpn_feature_sizes):
            w, h = int(fm[0]), int(fm[1])
            xs = (np.arange(w, dtype=np.float32) + 0.5) / w
            ys = (np.arange(h, dtype=np.float32) + 0.5) / h
            gx, gy = np.meshgrid(xs, ys)
            ctr = np.stack([gx, gy], axis=-1)[:, :, None, :]
            ratio_sqrt = np.sqrt(self.ratios)
            ws = scale * ratio_sqrt / self.resize
            hs = scale / ratio_sqrt / self.resize
            wh = np.stack([ws, hs], axis=-1)[None, None]
            anchors = np.concatenate(
                [np.broadcast_to(ctr, (h, w, len(self.ratios), 2)),
                 np.broadcast_to(wh, (h, w, len(self.ratios), 2))], axis=-1)
            out.append(anchors.reshape(-1, 4).astype(np.float32))
        return np.concatenate(out, axis=0)


def _conv(in_planes, planes, k=3, stride=1, dtype=torch.bfloat16):
    return Conv2d(in_planes, planes, k, stride, (k - 1) // 2, dtype=dtype,
                  normal_std=0.01)


class YOLACTFPN(nn.Module):
    """(C3, C4, C5) -> (P3, ..., P7): 1x1 laterals, align-corners bilinear
    top-down adds, a 3x3 convolution and ReLU per level, P6 and P7 stride-2
    3x3 convolutions and ReLUs off P5."""

    def __init__(self, in_channels: Sequence[int], planes: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lat_p3 = _conv(c3, planes, 1, dtype=dtype)
        self.lat_p4 = _conv(c4, planes, 1, dtype=dtype)
        self.lat_p5 = _conv(c5, planes, 1, dtype=dtype)
        self.pred_p3 = _conv(planes, planes, dtype=dtype)
        self.pred_p4 = _conv(planes, planes, dtype=dtype)
        self.pred_p5 = _conv(planes, planes, dtype=dtype)
        self.down_p6 = _conv(planes, planes, 3, 2, dtype=dtype)
        self.down_p7 = _conv(planes, planes, 3, 2, dtype=dtype)

    def forward(self, feats, train: bool = False):
        c3, c4, c5 = feats
        p5 = self.lat_p5(c5)
        p4 = self.lat_p4(c4)
        p4 = _upsample_to(p5, p4.shape[1], p4.shape[2]).to(p4.dtype) + p4
        p3 = self.lat_p3(c3)
        p3 = _upsample_to(p4, p3.shape[1], p3.shape[2]).to(p3.dtype) + p3
        p5 = F.relu(self.pred_p5(p5))
        p4 = F.relu(self.pred_p4(p4))
        p3 = F.relu(self.pred_p3(p3))
        p6 = F.relu(self.down_p6(p5))
        p7 = F.relu(self.down_p7(p6))
        return p3, p4, p5, p6, p7


class ProtoNet(nn.Module):
    """P3 -> ``planes`` prototypes at ``out_hw`` (an align-corners bilinear
    resize between the two convolution stacks), f32."""

    def __init__(self, in_planes: int, planes: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.proto1 = nn.ModuleList(_conv(in_planes, in_planes, dtype=dtype)
                                    for _ in range(3))
        self.proto2 = nn.ModuleList([
            _conv(in_planes, in_planes, dtype=dtype),
            _conv(in_planes, planes, 1, dtype=dtype)])

    def forward(self, x, out_hw):
        for conv in self.proto1:
            x = F.relu(conv(x))
        x = _upsample_to(x, out_hw[0], out_hw[1]).to(x.dtype)
        for conv in self.proto2:
            x = F.relu(conv(x))
        return x.float()


class YOLACTHead(nn.Module):

    def __init__(self, planes: int, num_anchors: int = 3,
                 proto_planes: int = 32, num_classes: int = 81,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = _conv(planes, planes, dtype=dtype)
        self.conf_pred_conv = _conv(planes, num_anchors * num_classes,
                                    dtype=dtype)
        self.bbox_pred_conv = _conv(planes, num_anchors * 4, dtype=dtype)
        self.coef_pred_conv = _conv(planes, num_anchors * proto_planes,
                                    dtype=dtype)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return (self.conf_pred_conv(x).float(),
                self.bbox_pred_conv(x).float(),
                torch.tanh(self.coef_pred_conv(x).float()))


class YOLACT(nn.Module):

    def __init__(self, backbone_type: str, fpn_planes: int = 256,
                 proto_planes: int = 32, num_classes: int = 81,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.proto_planes = num_classes, proto_planes
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = YOLACTFPN(self.backbone.feature_channels[-3:], fpn_planes,
                             dtype=dtype)
        self.proto_net = ProtoNet(fpn_planes, proto_planes, dtype=dtype)
        self.head = YOLACTHead(fpn_planes, 3, proto_planes, num_classes,
                               dtype=dtype)
        self.semantic_seg_conv = Conv2d(fpn_planes, num_classes - 1, 1,
                                        dtype=torch.float32, normal_std=0.01)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        feats = self.backbone(x, train)
        c2_hw = (feats[0].shape[1], feats[0].shape[2])
        fpn_feats = self.fpn(feats[-3:], train)
        proto_out = self.proto_net(fpn_feats[0], c2_hw)
        class_preds, box_preds, coef_preds = [], [], []
        for f in fpn_feats:
            conf, box, coef = self.head(f)
            b, h, w, _ = f.shape
            class_preds.append(conf.reshape(b, h, w, 3, self.num_classes))
            box_preds.append(box.reshape(b, h, w, 3, 4))
            coef_preds.append(coef.reshape(b, h, w, 3, self.proto_planes))
        seg_pred = self.semantic_seg_conv(fpn_feats[0].float())
        return class_preds, box_preds, coef_preds, proto_out, seg_pred


def _yolact(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return YOLACT(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_yolact(**kwargs):
    return _yolact("resnet18", **kwargs)


@MODELS.register()
def resnet34_yolact(**kwargs):
    return _yolact("resnet34", **kwargs)


@MODELS.register()
def resnet50_yolact(**kwargs):
    return _yolact("resnet50", **kwargs)


@MODELS.register()
def resnet101_yolact(**kwargs):
    return _yolact("resnet101", **kwargs)


@MODELS.register()
def resnet152_yolact(**kwargs):
    return _yolact("resnet152", **kwargs)


@MODELS.register()
def vanb2_yolact(**kwargs):
    return _yolact("van_b2", **kwargs)


@MODELS.register()
def convformerm36_yolact(**kwargs):
    return _yolact("convformer_m36", **kwargs)
