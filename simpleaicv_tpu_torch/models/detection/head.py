"""Dense detection heads (counterpart of
``simpleaicv_tpu/models/detection/head.py``), each one module that the
detector calls once per pyramid level.

RetinaNet's towers are 4 x (3x3 convolution with bias + ReLU); FCOS's are
4 x (3x3 convolution without bias + GroupNorm(32, eps 1e-5) in f32, cast
back to ``dtype`` before the ReLU). Tower convolutions start from a
normal(0.01) kernel; the classification output's bias starts at the prior
``-log((1 - 0.01) / 0.01)``. Class and centerness sigmoids run in f32.
NHWC; state-dict keys are the JAX names (``cls_head.0`` for ``cls_head_0``,
``cls_gn.0``, ``cls_out``, ``reg_out``, ``center_out``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..common import Conv2d, GroupNorm

__all__ = ["RetinaClsHead", "RetinaRegHead", "FCOSClsRegCntHead",
           "PRIOR_BIAS"]

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def _conv(in_planes, planes, dtype, bias=True, bias_fill=0.0):
    return Conv2d(in_planes, planes, 3, padding=1, bias=bias, dtype=dtype,
                  normal_std=0.01, bias_fill=bias_fill)


def _tower(planes, num_layers, dtype, bias=True):
    return nn.ModuleList(_conv(planes, planes, dtype, bias)
                         for _ in range(num_layers))


class RetinaClsHead(nn.Module):
    """[B, H, W, planes] -> [B, H, W, num_anchors * num_classes] f32
    probabilities."""

    def __init__(self, planes: int, num_anchors: int, num_classes: int,
                 num_layers: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cls_head = _tower(planes, num_layers, dtype)
        self.cls_out = _conv(planes, num_anchors * num_classes, dtype,
                             bias_fill=PRIOR_BIAS)

    def forward(self, x):
        for conv in self.cls_head:
            x = F.relu(conv(x))
        return torch.sigmoid(self.cls_out(x).float())


class RetinaRegHead(nn.Module):
    """[B, H, W, planes] -> [B, H, W, num_anchors * 4] in ``dtype``."""

    def __init__(self, planes: int, num_anchors: int, num_layers: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.reg_head = _tower(planes, num_layers, dtype)
        self.reg_out = _conv(planes, num_anchors * 4, dtype)

    def forward(self, x):
        for conv in self.reg_head:
            x = F.relu(conv(x))
        return self.reg_out(x)


class FCOSClsRegCntHead(nn.Module):
    """[B, H, W, planes] -> (class probabilities [B, H, W, num_classes] f32,
    distances [B, H, W, 4] in ``dtype``, centerness [B, H, W, 1] f32); the
    centerness branch reads the regression tower (``cnt_on_reg``) or the
    classification one."""

    def __init__(self, planes: int, num_classes: int, num_layers: int = 4,
                 use_gn: bool = True, cnt_on_reg: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.use_gn, self.cnt_on_reg, self.dtype = use_gn, cnt_on_reg, dtype
        for branch in ("cls", "reg"):
            self.add_module(f"{branch}_head", _tower(
                planes, num_layers, dtype, bias=not use_gn))
            if use_gn:
                self.add_module(f"{branch}_gn", nn.ModuleList(
                    GroupNorm(32, planes) for _ in range(num_layers)))
        self.cls_out = _conv(planes, num_classes, dtype, bias_fill=PRIOR_BIAS)
        self.reg_out = _conv(planes, 4, dtype)
        self.center_out = _conv(planes, 1, dtype)

    def _tower(self, x, branch):
        norms = getattr(self, f"{branch}_gn") if self.use_gn else None
        for i, conv in enumerate(getattr(self, f"{branch}_head")):
            x = conv(x)
            if norms is not None:
                x = norms[i](x).to(self.dtype)
            x = F.relu(x)
        return x

    def forward(self, x):
        cls_x = self._tower(x, "cls")
        reg_x = self._tower(x, "reg")
        cnt = self.center_out(reg_x if self.cnt_on_reg else cls_x)
        return (torch.sigmoid(self.cls_out(cls_x).float()),
                self.reg_out(reg_x), torch.sigmoid(cnt.float()))
