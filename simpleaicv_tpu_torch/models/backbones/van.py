"""VAN, the Visual Attention Network (counterpart of
``simpleaicv_tpu/models/backbones/van.py``): four stages of an overlapping
patch embedding and blocks of large-kernel attention with layer scales;
variants van_b0 ... van_b6.

LKA is a 5x5 depthwise convolution, a 7x7 depthwise convolution at
dilation 3 with padding 9 and a 1x1 convolution, gating its input by a
product. A block is

    x = x + drop_path(layer_scale_1 * Attention(norm1(x)))
    x = x + drop_path(layer_scale_2 * Mlp(norm2(x)))

with the layer scales f32 parameters (1e-5 at init) multiplying the
compute-dtype branch, the product cast to the residual's dtype. The norms
are flax ``BatchNorm`` (``models.common.BatchNorm``: unshifted, the biased
variance blended), their f32 outputs cast to the compute dtype; one closes
each stage. ``OverlapPatchEmbed`` pads k // 2. Every convolution has a
bias. ``features_only`` returns the four stages' outputs; otherwise a
global mean in f32 and an f32 ``head``. With ``use_gradient_checkpoint``
each block is recomputed in the backward.

Images are NHWC. State-dict keys follow the JAX tree: ``patch_embed1.proj``,
``block1.0.layer_scale_1``, ``block2.1.attn.spatial_gating_unit.conv0``,
``block3.0.mlp.dwconv``, ``norm4``, ``head``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES
from ..common import (BatchNorm, Conv2d, Linear, checkpoint_replaying,
                      drop_path, dropout, norm_to)

__all__ = ["VAN", "van_b0", "van_b1", "van_b2", "van_b3", "van_b4", "van_b5",
           "van_b6"]


class LKA(nn.Module):

    def __init__(self, planes: int, dtype: torch.dtype):
        super().__init__()
        self.conv0 = Conv2d(planes, planes, 5, 1, 2, dtype=dtype,
                            groups=planes)
        self.conv_spatial = Conv2d(planes, planes, 7, 1, 9, dtype=dtype,
                                   dilation=3, groups=planes)
        self.conv1 = Conv2d(planes, planes, 1, dtype=dtype)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class VANAttention(nn.Module):

    def __init__(self, planes: int, dtype: torch.dtype):
        super().__init__()
        self.proj_1 = Conv2d(planes, planes, 1, dtype=dtype)
        self.spatial_gating_unit = LKA(planes, dtype)
        self.proj_2 = Conv2d(planes, planes, 1, dtype=dtype)

    def forward(self, x):
        h = self.spatial_gating_unit(F.relu(self.proj_1(x)))
        return self.proj_2(h) + x


class VANMlp(nn.Module):

    def __init__(self, planes: int, hidden: int, dropout_prob: float,
                 dtype: torch.dtype):
        super().__init__()
        self.fc1 = Conv2d(planes, hidden, 1, dtype=dtype)
        self.dwconv = Conv2d(hidden, hidden, 3, 1, 1, dtype=dtype,
                             groups=hidden)
        self.fc2 = Conv2d(hidden, planes, 1, dtype=dtype)
        self.dropout_prob = dropout_prob

    def forward(self, x, train: bool, generator=None):
        x = F.relu(self.dwconv(self.fc1(x)))
        x = dropout(x, self.dropout_prob, train, generator)
        return dropout(self.fc2(x), self.dropout_prob, train, generator)


class VANBlock(nn.Module):

    def __init__(self, planes: int, mlp_ratio: int, dropout_prob: float,
                 drop_path_prob: float, dtype: torch.dtype):
        super().__init__()
        self.layer_scale_1 = nn.Parameter(torch.empty(planes))
        self.layer_scale_2 = nn.Parameter(torch.empty(planes))
        self.norm1 = BatchNorm(planes)
        self.attn = VANAttention(planes, dtype)
        self.norm2 = BatchNorm(planes)
        self.mlp = VANMlp(planes, int(planes * mlp_ratio), dropout_prob, dtype)
        self.drop_path_prob, self.dtype = drop_path_prob, dtype

    def reset_parameters(self, generator):
        nn.init.constant_(self.layer_scale_1, 1e-5)
        nn.init.constant_(self.layer_scale_2, 1e-5)

    def forward(self, x, train: bool, generator=None):
        h = self.attn(norm_to(self.norm1, x, train, self.dtype))
        x = x + drop_path((self.layer_scale_1 * h).to(x.dtype),
                          self.drop_path_prob, train, generator)
        h = self.mlp(norm_to(self.norm2, x, train, self.dtype), train,
                     generator)
        return x + drop_path((self.layer_scale_2 * h).to(x.dtype),
                             self.drop_path_prob, train, generator)


class OverlapPatchEmbed(nn.Module):

    def __init__(self, in_planes: int, planes: int, patch_size: int,
                 stride: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Conv2d(in_planes, planes, patch_size, stride,
                           patch_size // 2, dtype=dtype)
        self.norm = BatchNorm(planes)
        self.dtype = dtype

    def forward(self, x, train: bool):
        return norm_to(self.norm, self.proj(x), train, self.dtype)


class VAN(nn.Module):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits, or with
    ``features_only`` the four stages' outputs in ``dtype``; their channel
    counts are ``feature_channels``."""

    def __init__(self, embedding_planes: Sequence[int] = (64, 128, 256, 512),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4),
                 block_nums: Sequence[int] = (3, 4, 6, 3),
                 dropout_prob: float = 0.0, drop_path_prob: float = 0.0,
                 num_classes: int = 1000,
                 use_gradient_checkpoint: bool = False,
                 features_only: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        total = sum(block_nums)
        dpp = [drop_path_prob * i / max(total - 1, 1) for i in range(total)]
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.features_only = features_only
        self.feature_channels = list(embedding_planes)
        self.dtype = dtype
        inplanes, idx = 3, 0
        for i, (planes, ratio, n) in enumerate(
                zip(embedding_planes, mlp_ratios, block_nums)):
            self.add_module(f"patch_embed{i + 1}", OverlapPatchEmbed(
                inplanes, planes, 7 if i == 0 else 3, 4 if i == 0 else 2,
                dtype))
            self.add_module(f"block{i + 1}", nn.ModuleList(
                VANBlock(planes, ratio, dropout_prob, dpp[idx + j], dtype)
                for j in range(n)))
            self.add_module(f"norm{i + 1}", BatchNorm(planes))
            idx += n
            inplanes = planes
        self.num_stages = len(block_nums)
        self.head = None if features_only else Linear(inplanes, num_classes)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode (``model.train()``)."""
        if train is None:
            train = self.training
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"patch_embed{i}")(x, train)
            for blk in getattr(self, f"block{i}"):
                if remat:
                    x = checkpoint_replaying(blk, generator, x, train)
                else:
                    x = blk(x, train, generator)
            x = norm_to(getattr(self, f"norm{i}"), x, train, self.dtype)
            features.append(x)
        if self.features_only:
            return tuple(features)
        return self.head(x.float().mean(dim=(1, 2)))


def _van(embedding_planes, mlp_ratios, block_nums, **kwargs):
    return VAN(embedding_planes=embedding_planes, mlp_ratios=mlp_ratios,
               block_nums=block_nums, **kwargs)


@BACKBONES.register()
def van_b0(**kwargs):
    return _van((32, 64, 160, 256), (8, 8, 4, 4), (3, 3, 5, 2), **kwargs)


@BACKBONES.register()
def van_b1(**kwargs):
    return _van((64, 128, 320, 512), (8, 8, 4, 4), (2, 2, 4, 2), **kwargs)


@BACKBONES.register()
def van_b2(**kwargs):
    return _van((64, 128, 320, 512), (8, 8, 4, 4), (3, 3, 12, 3), **kwargs)


@BACKBONES.register()
def van_b3(**kwargs):
    return _van((64, 128, 320, 512), (8, 8, 4, 4), (3, 5, 27, 3), **kwargs)


@BACKBONES.register()
def van_b4(**kwargs):
    return _van((64, 128, 320, 512), (8, 8, 4, 4), (3, 6, 40, 3), **kwargs)


@BACKBONES.register()
def van_b5(**kwargs):
    return _van((96, 192, 480, 768), (8, 8, 4, 4), (3, 3, 24, 3), **kwargs)


@BACKBONES.register()
def van_b6(**kwargs):
    return _van((96, 192, 384, 768), (8, 8, 4, 4), (6, 6, 90, 6), **kwargs)
