"""ResNet-18/34/50/101/152 (counterpart of
``simpleaicv_tpu/models/backbones/resnet.py``): a 7x7/2 stem and a 3x3/2
max-pool, BasicBlock or Bottleneck stages of 64, 128, 256, 512 planes
(expansion 1 or 4), and a global average pool and ``fc`` head, or with
``features_only`` the four stages' outputs C2-C5.

Images are NHWC. Convolutions compute in ``dtype`` (bf16 by default) from
f32 parameters, BatchNorm statistics in f32 (``models.common.ConvBnAct``).
``train`` (default: the module's mode) selects the BatchNorm's batch
statistics and updates the running ones. With ``use_gradient_checkpoint``
each block is recomputed in the backward. State-dict keys follow the JAX
tree: ``stem.conv``, ``stem.bn``, ``layer1.0.conv1.conv``,
``layer1.0.downsample.bn``, ``fc``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES
from ..common import ConvBnAct, Linear, checkpoint, max_pool_same

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = ConvBnAct(inplanes, planes, 3, stride, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, 3, 1, has_act=False,
                               dtype=dtype)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = ConvBnAct(inplanes, planes, 1, stride,
                                        has_act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv2(self.conv1(x, train), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        outplanes = planes * self.expansion
        self.conv1 = ConvBnAct(inplanes, planes, 1, 1, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, 3, stride, dtype=dtype)
        self.conv3 = ConvBnAct(planes, outplanes, 1, 1, has_act=False,
                               dtype=dtype)
        self.downsample = None
        if stride != 1 or inplanes != outplanes:
            self.downsample = ConvBnAct(inplanes, outplanes, 1, stride,
                                        has_act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv3(self.conv2(self.conv1(x, train), train), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return F.relu(out + x)


class ResNet(nn.Module):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits, or with
    ``features_only`` the tuple (C2, C3, C4, C5) in ``dtype``; their
    channel counts are ``feature_channels``."""

    def __init__(self, block, layer_nums: Sequence[int], inplanes: int = 64,
                 num_classes: int = 1000, use_gradient_checkpoint: bool = False,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.features_only = features_only
        self.stem = ConvBnAct(3, inplanes, 7, 2, dtype=dtype)
        self.feature_channels = []
        channels, planes = inplanes, inplanes
        for stage, n in enumerate(layer_nums):
            blocks = []
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(channels, planes, stride, dtype))
                channels = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.ModuleList(blocks))
            self.feature_channels.append(channels)
            planes *= 2
        self.num_stages = len(layer_nums)
        self.fc = None if features_only else Linear(channels, num_classes)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode (``model.train()``), as
        the engine sets it; ``generator`` is unused (no stochastic layer)."""
        if train is None:
            train = self.training
        x = max_pool_same(self.stem(x, train), 3, 2)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for stage in range(self.num_stages):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = checkpoint(blk, x, train) if remat else blk(x, train)
            features.append(x)
        if self.features_only:
            return tuple(features)
        return self.fc(x.float().mean(dim=(1, 2)))


def _resnet(block, layers, **kwargs):
    return ResNet(block, layers, 64, **kwargs)


@BACKBONES.register()
def resnet18(**kwargs):
    return _resnet(BasicBlock, [2, 2, 2, 2], **kwargs)


@BACKBONES.register()
def resnet34(**kwargs):
    return _resnet(BasicBlock, [3, 4, 6, 3], **kwargs)


@BACKBONES.register()
def resnet50(**kwargs):
    return _resnet(Bottleneck, [3, 4, 6, 3], **kwargs)


@BACKBONES.register()
def resnet101(**kwargs):
    return _resnet(Bottleneck, [3, 4, 23, 3], **kwargs)


@BACKBONES.register()
def resnet152(**kwargs):
    return _resnet(Bottleneck, [3, 8, 36, 3], **kwargs)
