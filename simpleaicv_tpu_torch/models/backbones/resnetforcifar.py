"""ResNet for CIFAR (counterpart of
``simpleaicv_tpu/models/backbones/resnetforcifar.py``): ResNet's
BasicBlock or Bottleneck stages after a 3x3 stride-1 ``ConvBnAct`` stem
with no max pool, then a global average pool and an f32 ``fc`` head;
variants resnet{18,34,50,101,152}cifar.

Images are NHWC; the blocks and their shifted train-mode BatchNorm are the
port's ResNet's (``models/backbones/resnet.py``, ``ops/fused_bn.py``).
State-dict keys follow the JAX tree: ``stem.conv``, ``stem.bn``,
``layer1.0.conv1.conv``, ``fc``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...core.registry import BACKBONES
from ..common import ConvBnAct, Linear, checkpoint
from .resnet import BasicBlock, Bottleneck

__all__ = ["ResNetCifar", "resnet18cifar", "resnet34cifar", "resnet50cifar",
           "resnet101cifar", "resnet152cifar"]


class ResNetCifar(nn.Module):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits."""

    def __init__(self, block, layer_nums: Sequence[int], inplanes: int = 64,
                 num_classes: int = 100, use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.stem = ConvBnAct(3, inplanes, 3, 1, dtype=dtype)
        channels, planes = inplanes, inplanes
        for stage, n in enumerate(layer_nums):
            blocks = []
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(channels, planes, stride, dtype))
                channels = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.ModuleList(blocks))
            planes *= 2
        self.num_stages = len(layer_nums)
        self.fc = Linear(channels, num_classes)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        if train is None:
            train = self.training
        x = self.stem(x, train)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        for stage in range(self.num_stages):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = checkpoint(blk, x, train) if remat else blk(x, train)
        return self.fc(x.float().mean(dim=(1, 2)))


def _resnetcifar(block, layers, **kwargs):
    return ResNetCifar(block, layers, 64, **kwargs)


@BACKBONES.register()
def resnet18cifar(**kwargs):
    return _resnetcifar(BasicBlock, [2, 2, 2, 2], **kwargs)


@BACKBONES.register()
def resnet34cifar(**kwargs):
    return _resnetcifar(BasicBlock, [3, 4, 6, 3], **kwargs)


@BACKBONES.register()
def resnet50cifar(**kwargs):
    return _resnetcifar(Bottleneck, [3, 4, 6, 3], **kwargs)


@BACKBONES.register()
def resnet101cifar(**kwargs):
    return _resnetcifar(Bottleneck, [3, 4, 23, 3], **kwargs)


@BACKBONES.register()
def resnet152cifar(**kwargs):
    return _resnetcifar(Bottleneck, [3, 8, 36, 3], **kwargs)
