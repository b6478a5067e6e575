"""ConvFormer, a MetaFormer with a separable-convolution token mixer
(counterpart of ``simpleaicv_tpu/models/backbones/convformer.py``); variants
convformer_{s18,s36,m36,b36}.

This is the JAX package's ConvFormer, not the published one with StarReLU
and LayerNorm. Its norms are flax ``BatchNorm`` (``models.common.BatchNorm``:
f32, momentum 0.9, eps 1e-5, unshifted, the biased variance blended), each
output cast back to the compute dtype. A block is

    x = x + drop_path(SepConv(norm1(x)))
    x = x + drop_path(Mlp(norm2(x)))

with ``SepConv`` = Dense -> ReLU -> 7x7 depthwise -> Dense and ``Mlp`` =
Dense -> ReLU -> Dense, all without biases; the residual stream keeps its
input's dtype. The stem is a 7x7 stride-4 convolution with padding 2 and a
post-norm; the later stages start with a pre-norm and a 3x3 stride-2
convolution. Drop-path probabilities rise as ``i / max(total - 1, 1)``.
``features_only`` returns the four stages' outputs; otherwise a global mean
in f32 and an f32 ``head``. With ``use_gradient_checkpoint`` each block is
recomputed in the backward.

Images are NHWC. State-dict keys follow the JAX tree:
``downsample_layers.0.conv``, ``downsample_layers.1.pre_norm``,
``stages.2.5.token_mixer.dwconv``, ``stages.0.0.mlp.fc1``, ``head``.
Dropout and drop-path masks come from the ``generator`` passed to
``forward``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES
from ..common import (BatchNorm, Conv2d, Linear, checkpoint_replaying,
                      drop_path, dropout, norm_to)

__all__ = ["MetaFormer", "convformer_s18", "convformer_s36", "convformer_m36",
           "convformer_b36"]


class Downsampling(nn.Module):

    def __init__(self, in_planes: int, planes: int, kernel_size: int,
                 stride: int, padding: int, pre_norm: bool, post_norm: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.pre_norm = BatchNorm(in_planes) if pre_norm else None
        self.conv = Conv2d(in_planes, planes, kernel_size, stride, padding,
                           dtype=dtype)
        self.post_norm = BatchNorm(planes) if post_norm else None
        self.dtype = dtype

    def forward(self, x, train: bool):
        if self.pre_norm is not None:
            x = norm_to(self.pre_norm, x, train, self.dtype)
        x = self.conv(x)
        if self.post_norm is not None:
            x = norm_to(self.post_norm, x, train, self.dtype)
        return x


class SepConv(nn.Module):

    def __init__(self, planes: int, kernel_size: int = 7,
                 expand_ratio: int = 2, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        mid = int(expand_ratio * planes)
        self.pwconv1 = Linear(planes, mid, bias=False, dtype=dtype)
        self.dwconv = Conv2d(mid, mid, kernel_size, 1, (kernel_size - 1) // 2,
                             bias=False, dtype=dtype, groups=mid)
        self.pwconv2 = Linear(mid, planes, bias=False, dtype=dtype)

    def forward(self, x):
        return self.pwconv2(self.dwconv(F.relu(self.pwconv1(x))))


class Mlp(nn.Module):

    def __init__(self, planes: int, mlp_ratio: int = 4,
                 dropout_prob: float = 0.0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(planes, int(mlp_ratio * planes), bias=False,
                          dtype=dtype)
        self.fc2 = Linear(int(mlp_ratio * planes), planes, bias=False,
                          dtype=dtype)
        self.dropout_prob = dropout_prob

    def forward(self, x, train: bool, generator=None):
        x = dropout(F.relu(self.fc1(x)), self.dropout_prob, train, generator)
        return dropout(self.fc2(x), self.dropout_prob, train, generator)


class MetaFormerBlock(nn.Module):

    def __init__(self, planes: int, dropout_prob: float,
                 drop_path_prob: float, dtype: torch.dtype):
        super().__init__()
        self.norm1 = BatchNorm(planes)
        self.token_mixer = SepConv(planes, dtype=dtype)
        self.norm2 = BatchNorm(planes)
        self.mlp = Mlp(planes, dropout_prob=dropout_prob, dtype=dtype)
        self.drop_path_prob, self.dtype = drop_path_prob, dtype

    def forward(self, x, train: bool, generator=None):
        h = self.token_mixer(norm_to(self.norm1, x, train, self.dtype))
        x = x + drop_path(h.to(x.dtype), self.drop_path_prob, train,
                          generator)
        h = self.mlp(norm_to(self.norm2, x, train, self.dtype), train,
                     generator)
        return x + drop_path(h.to(x.dtype), self.drop_path_prob, train,
                             generator)


class MetaFormer(nn.Module):
    """[B, H, W, 3] images -> [B, num_classes] f32 logits, or with
    ``features_only`` the four stages' outputs in ``dtype``; their channel
    counts are ``feature_channels``."""

    def __init__(self, embedding_planes: Sequence[int] = (64, 128, 320, 512),
                 block_nums: Sequence[int] = (2, 2, 6, 2),
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
        downsample, stages = [], []
        inplanes, idx = 3, 0
        for i, (planes, n) in enumerate(zip(embedding_planes, block_nums)):
            if i == 0:
                downsample.append(Downsampling(inplanes, planes, 7, 4, 2,
                                               False, True, dtype))
            else:
                downsample.append(Downsampling(inplanes, planes, 3, 2, 1,
                                               True, False, dtype))
            stages.append(nn.ModuleList(
                MetaFormerBlock(planes, dropout_prob, dpp[idx + j], dtype)
                for j in range(n)))
            idx += n
            inplanes = planes
        self.downsample_layers = nn.ModuleList(downsample)
        self.stages = nn.ModuleList(stages)
        self.head = None if features_only else Linear(inplanes, num_classes)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode (``model.train()``)."""
        if train is None:
            train = self.training
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = down(x, train)
            for blk in stage:
                if remat:
                    x = checkpoint_replaying(blk, generator, x, train)
                else:
                    x = blk(x, train, generator)
            features.append(x)
        if self.features_only:
            return tuple(features)
        return self.head(x.float().mean(dim=(1, 2)))


def _metaformer(block_nums, embedding_planes, **kwargs):
    return MetaFormer(block_nums=block_nums,
                      embedding_planes=embedding_planes, **kwargs)


@BACKBONES.register()
def convformer_s18(**kwargs):
    return _metaformer((3, 3, 9, 3), (64, 128, 320, 512), **kwargs)


@BACKBONES.register()
def convformer_s36(**kwargs):
    return _metaformer((3, 12, 18, 3), (64, 128, 320, 512), **kwargs)


@BACKBONES.register()
def convformer_m36(**kwargs):
    return _metaformer((3, 12, 18, 3), (96, 192, 384, 576), **kwargs)


@BACKBONES.register()
def convformer_b36(**kwargs):
    return _metaformer((3, 12, 18, 3), (128, 256, 512, 768), **kwargs)
