"""DarkNet tiny, 19 and 53 (counterpart of
``simpleaicv_tpu/models/backbones/darknet.py``): ``ConvBnAct`` layers with
LeakyReLU 0.1 (ReLU with ``act_type="relu"``) and flax's VALID 2x2
stride-2 max pools.

DarkNet-tiny's last pool pads the bottom and right with zeros and then
takes a 2x2 stride-1 max (``darknet.py:68-69``). After a LeakyReLU a
negative value can lose to that zero, so the pad is ``F.pad(value=0)``,
not the ``-inf`` of ``max_pool2d(padding=)``. DarkNet-19 ends in a 1x1
convolution with a bias to the classes and a global mean; the others in a
global mean and an f32 ``fc``. ``Darknet53(features_only=True)`` returns
C3, C4, C5.

Images are NHWC; state-dict keys follow the JAX tree (``conv1.conv``,
``layer2.conv0.bn``, ``block3.5.conv2.conv``, ``fc``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES
from ..common import ConvBnAct, Linear

__all__ = ["DarknetTiny", "Darknet19", "Darknet53", "darknettiny",
           "darknet19", "darknet53"]


def _act(act_type):
    if act_type == "leakyrelu":
        return functools.partial(F.leaky_relu, negative_slope=0.1)
    return F.relu


def _max_pool(x, stride: int = 2):
    """flax ``nn.max_pool(x, (2, 2), strides=(stride, stride))`` (VALID) on
    an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, stride).permute(0, 2, 3, 1)


class Darknet19Block(nn.Module):

    def __init__(self, inplanes: int, planes: int, layer_num: int,
                 use_maxpool: bool, act, dtype: torch.dtype):
        super().__init__()
        for i in range(layer_num):
            if i % 2 == 0:
                conv = ConvBnAct(inplanes, planes, 3, 1, dtype=dtype, act=act)
            else:
                conv = ConvBnAct(planes, inplanes, 1, 1, dtype=dtype, act=act)
            self.add_module(f"conv{i}", conv)
        self.layer_num, self.use_maxpool = layer_num, use_maxpool

    def forward(self, x, train: bool):
        for i in range(self.layer_num):
            x = getattr(self, f"conv{i}")(x, train)
        return _max_pool(x) if self.use_maxpool else x


class Darknet53Block(nn.Module):

    def __init__(self, planes: int, act, dtype: torch.dtype):
        super().__init__()
        self.conv1 = ConvBnAct(planes, planes // 2, 1, 1, dtype=dtype, act=act)
        self.conv2 = ConvBnAct(planes // 2, planes, 3, 1, dtype=dtype, act=act)

    def forward(self, x, train: bool):
        return self.conv2(self.conv1(x, train), train) + x


class _DarkNet(nn.Module):

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; ``generator`` is unused
        (no stochastic layer)."""
        return self._forward(x, self.training if train is None else train)


class DarknetTiny(_DarkNet):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits."""

    def __init__(self, act_type: str = "leakyrelu", num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        act = _act(act_type)
        inplanes = 3
        for i, planes in enumerate([16, 32, 64, 128, 256]):
            self.add_module(f"conv{i + 1}", ConvBnAct(
                inplanes, planes, 3, 1, dtype=dtype, act=act))
            inplanes = planes
        self.conv6 = ConvBnAct(256, 512, 3, 1, dtype=dtype, act=act)
        self.fc = Linear(512, num_classes)

    def _forward(self, x, train):
        for i in range(5):
            x = _max_pool(getattr(self, f"conv{i + 1}")(x, train))
        x = self.conv6(x, train)
        x = _max_pool(F.pad(x, (0, 0, 0, 1, 0, 1), value=0.0), stride=1)
        return self.fc(x.float().mean(dim=(1, 2)))


class Darknet19(_DarkNet):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits."""

    def __init__(self, act_type: str = "leakyrelu", num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        act = _act(act_type)
        self.layer1 = ConvBnAct(3, 32, 3, 1, dtype=dtype, act=act)
        inplanes = 32
        for i, (planes, n, pool) in enumerate([(64, 1, True), (128, 3, True),
                                               (256, 3, True), (512, 5, True),
                                               (1024, 5, False)]):
            self.add_module(f"layer{i + 2}", Darknet19Block(
                inplanes, planes, n, pool, act, dtype))
            inplanes = planes
        self.layer7 = ConvBnAct(1024, num_classes, 1, 1, has_bn=False,
                                has_act=False, dtype=dtype)

    def _forward(self, x, train):
        x = _max_pool(self.layer1(x, train))
        for i in range(2, 8):
            x = getattr(self, f"layer{i}")(x, train)
        return x.float().mean(dim=(1, 2))


class Darknet53(_DarkNet):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits, or with
    ``features_only`` the tuple (C3, C4, C5); their channel counts are
    ``feature_channels``."""

    def __init__(self, act_type: str = "leakyrelu", num_classes: int = 1000,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        act = _act(act_type)
        self.features_only = features_only
        self.conv1 = ConvBnAct(3, 32, 3, 1, dtype=dtype, act=act)
        self.conv2 = ConvBnAct(32, 64, 3, 2, dtype=dtype, act=act)
        inplanes = 64
        for stage, (planes, n) in enumerate(zip([64, 128, 256, 512, 1024],
                                                [1, 2, 8, 8, 4])):
            if stage > 0:
                self.add_module(f"conv{stage + 2}", ConvBnAct(
                    inplanes, planes, 3, 2, dtype=dtype, act=act))
            self.add_module(f"block{stage + 1}", nn.ModuleList(
                Darknet53Block(planes, act, dtype) for _ in range(n)))
            inplanes = planes
        self.feature_channels = [256, 512, 1024]
        self.fc = None if features_only else Linear(1024, num_classes)

    def _forward(self, x, train):
        x = self.conv2(self.conv1(x, train), train)
        features = []
        for stage in range(5):
            if stage > 0:
                x = getattr(self, f"conv{stage + 2}")(x, train)
            for blk in getattr(self, f"block{stage + 1}"):
                x = blk(x, train)
            features.append(x)
        if self.features_only:
            return tuple(features[-3:])
        return self.fc(x.float().mean(dim=(1, 2)))


@BACKBONES.register()
def darknettiny(**kwargs):
    return DarknetTiny(**kwargs)


@BACKBONES.register()
def darknet19(**kwargs):
    return Darknet19(**kwargs)


@BACKBONES.register()
def darknet53(**kwargs):
    return Darknet53(**kwargs)
