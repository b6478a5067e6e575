"""RetinaFace face detection (counterpart of
``simpleaicv_tpu/models/face_detection.py``): a ResNet's C3-C5, a 3-level
FPN of ``ConvBnAct`` layers (1x1 laterals, each coarser level resized
align-corners and added, a 3x3 merge on the two finer ones), an SSH context
module per level (3x3, stacked 3x3 for 5x5 and 7x7, concatenated, ReLU),
and per level 1x1 f32 convolutions for a 1-class sigmoid and the boxes;
square anchors per level (``RetinaFaceAnchors``). The loss is
``RetinaLoss`` on those anchors with one IoU threshold of 0.35 and a CIoU
box loss; the decoder floors its boxes.

NHWC; ``ConvBnAct`` is the backbone's (``ops.fused_bn``). State-dict keys
are the JAX paths (``fpn.output1.conv``, ``sshs.0.conv5X5_1.bn``,
``cls_convs.2``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import BACKBONES, DECODERS, LOSSES, MODELS
from ..losses.detection import RetinaLoss
from .common import Conv2d, ConvBnAct
from .detection.anchor import (OnDevice, anchor_boxes, feature_sizes,
                               flatten_levels)
from .detection.decode import _DecoderBase
from .detection.fpn import _upsample_to

__all__ = ["RetinaFace", "RetinaFaceAnchors", "RetinaFaceLoss",
           "RetinaFaceDecoder", "resnet18_retinaface", "resnet34_retinaface",
           "resnet50_retinaface", "resnet101_retinaface",
           "resnet152_retinaface"]

ANCHOR_SIZES = ((8, 16, 32), (32, 64, 128), (128, 256, 512))
STRIDES = (8, 16, 32)


class RetinaFaceAnchors:
    """Square anchors of ``anchor_sizes`` per level, centred on each cell
    at ``(i + 0.5) * stride`` (numpy, as the JAX package's)."""

    def __init__(self, anchor_sizes=ANCHOR_SIZES, strides=STRIDES):
        self.anchor_sizes = [np.asarray(s, np.float32) for s in anchor_sizes]
        self.strides = np.asarray(strides, np.float32)

    def flat_anchors(self, fpn_feature_sizes):
        out = []
        for sizes, stride, fm in zip(self.anchor_sizes, self.strides,
                                     fpn_feature_sizes):
            w, h = int(fm[0]), int(fm[1])
            base = np.zeros((len(sizes), 4), np.float32)
            base[:, 0] = -sizes / 2
            base[:, 1] = -sizes / 2
            base[:, 2] = sizes / 2
            base[:, 3] = sizes / 2
            sx = (np.arange(w, dtype=np.float32) + 0.5) * stride
            sy = (np.arange(h, dtype=np.float32) + 0.5) * stride
            shift = np.stack(np.meshgrid(sx, sy), axis=-1)
            shift = np.tile(shift, (1, 1, 2))[:, :, None, :]
            out.append((base[None, None] + shift).reshape(-1, 4))
        return np.concatenate(out, axis=0)


class RetinaFaceFPN(nn.Module):

    def __init__(self, in_channels, planes: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"output{i + 1}",
                            ConvBnAct(c, planes, 1, dtype=dtype))
        self.merge2 = ConvBnAct(planes, planes, 3, dtype=dtype)
        self.merge1 = ConvBnAct(planes, planes, 3, dtype=dtype)

    def forward(self, inputs, train: bool = False):
        c3, c4, c5 = inputs
        out1 = self.output1(c3, train)
        out2 = self.output2(c4, train)
        out3 = self.output3(c5, train)
        out2 = out2 + _upsample_to(out3, out2.shape[1], out2.shape[2])
        out2 = self.merge2(out2, train)
        out1 = out1 + _upsample_to(out2, out1.shape[1], out1.shape[2])
        out1 = self.merge1(out1, train)
        return [out1, out2, out3]


class RetinaFaceSSH(nn.Module):

    def __init__(self, planes: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p = planes
        self.conv3X3 = ConvBnAct(p, p // 2, 3, has_act=False, dtype=dtype)
        self.conv5X5_1 = ConvBnAct(p, p // 4, 3, dtype=dtype)
        self.conv5X5_2 = ConvBnAct(p // 4, p // 4, 3, has_act=False,
                                   dtype=dtype)
        self.conv7X7_1 = ConvBnAct(p // 4, p // 4, 3, dtype=dtype)
        self.conv7X7_2 = ConvBnAct(p // 4, p // 4, 3, has_act=False,
                                   dtype=dtype)

    def forward(self, x, train: bool = False):
        b3 = self.conv3X3(x, train)
        m5 = self.conv5X5_1(x, train)
        b5 = self.conv5X5_2(m5, train)
        b7 = self.conv7X7_2(self.conv7X7_1(m5, train), train)
        return F.relu(torch.cat([b3, b5, b7], dim=-1))


class RetinaFace(nn.Module):
    """[B, H, W, 3] images -> [cls per level [B, h, w, A, 1] f32
    probabilities, boxes per level [B, h, w, A, 4] f32]."""

    def __init__(self, backbone_type: str, planes: int = 256,
                 anchor_num: int = 3, use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.anchor_num = anchor_num
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = RetinaFaceFPN(self.backbone.feature_channels[-3:], planes,
                                 dtype)
        self.sshs = nn.ModuleList(RetinaFaceSSH(planes, dtype)
                                  for _ in range(3))
        self.cls_convs = nn.ModuleList(Conv2d(planes, anchor_num, 1)
                                       for _ in range(3))
        self.box_convs = nn.ModuleList(Conv2d(planes, anchor_num * 4, 1)
                                       for _ in range(3))

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        feats = self.fpn(self.backbone(x, train)[-3:], train)
        cls_heads, box_heads = [], []
        for i, f in enumerate(feats):
            f = self.sshs[i](f, train).float()
            b, h, w, _ = f.shape
            cls = torch.sigmoid(self.cls_convs[i](f))
            cls_heads.append(cls.reshape(b, h, w, self.anchor_num, 1))
            box_heads.append(self.box_convs[i](f).reshape(
                b, h, w, self.anchor_num, 4))
        return [cls_heads, box_heads]


@LOSSES.register()
class RetinaFaceLoss(RetinaLoss):
    """``RetinaLoss`` on the square face anchors, a 1-class sigmoid, and one
    IoU threshold of 0.35: below it background, at or above it positive."""

    thresholds = (0.35, 0.35)

    def __init__(self, anchor_sizes=ANCHOR_SIZES, strides=STRIDES,
                 alpha=0.25, gamma=2.0, beta=1.0 / 9.0, cls_loss_weight=1.0,
                 box_loss_weight=1.0, box_loss_type="CIoU"):
        super().__init__(alpha=alpha, gamma=gamma, beta=beta,
                         cls_loss_weight=cls_loss_weight,
                         box_loss_weight=box_loss_weight,
                         box_loss_type=box_loss_type)
        self._set_anchors(RetinaFaceAnchors(anchor_sizes, strides))


@DECODERS.register()
class RetinaFaceDecoder(_DecoderBase):
    """``decoder(preds) -> [scores [B, M], classes [B, M] (0), boxes
    [B, M, 4]]`` as numpy f32; the boxes are floored."""

    def __init__(self, anchor_sizes=ANCHOR_SIZES, strides=STRIDES,
                 **kwargs):
        super().__init__(**kwargs)
        self.anchors = RetinaFaceAnchors(anchor_sizes, strides)
        self._anchors_on = OnDevice(lambda sizes: (
            self.anchors.flat_anchors(sizes),))

    @torch.no_grad()
    def __call__(self, preds):
        cls_preds, reg_preds = preds
        anchors, = self._anchors_on(feature_sizes(cls_preds),
                                    cls_preds[0].device)
        scores = flatten_levels(cls_preds, 1)[..., 0].float()
        boxes = torch.floor(anchor_boxes(flatten_levels(reg_preds, 4),
                                         anchors))
        return self._decode(scores, torch.zeros_like(scores), boxes)


def _retinaface(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return RetinaFace(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_retinaface(**kwargs):
    return _retinaface("resnet18", **kwargs)


@MODELS.register()
def resnet34_retinaface(**kwargs):
    return _retinaface("resnet34", **kwargs)


@MODELS.register()
def resnet50_retinaface(**kwargs):
    return _retinaface("resnet50", **kwargs)


@MODELS.register()
def resnet101_retinaface(**kwargs):
    return _retinaface("resnet101", **kwargs)


@MODELS.register()
def resnet152_retinaface(**kwargs):
    return _retinaface("resnet152", **kwargs)
