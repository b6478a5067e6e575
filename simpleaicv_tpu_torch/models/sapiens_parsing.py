"""Sapiens face and human parsing (counterpart of
``simpleaicv_tpu/models/sapiens_parsing.py``).

The backbone is the reference's ViTBackbone: a patch convolution with bias,
a learned position encoding with no cls token, the ViT's
``TransformerEncoderLayer`` stack on its einsum attention (the JAX model
leaves flash attention off and has no field to turn it on), and no final
norm; the tokens go back to a [B, S/16, S/16, C] map in f32. The head,
all in f32: 4 x (4x4 stride-2 transposed convolution without bias,
InstanceNorm, SiLU) back to the input's size, 4 x (1x1 convolution
without bias, InstanceNorm, SiLU), and a 1x1 prediction convolution with
bias: [B, S, S, num_classes] logits.

The backbone's widths come from the backbone registry (``sapiens_0_3b``:
patch 16, 1024 wide, 24 blocks of 16 heads), read off a copy built on the
meta device, which holds no memory. With ``use_gradient_checkpoint`` each
block is recomputed in the backward; the dropout after the position
encoding draws from the step's generator. State-dict keys are the JAX
names (``patch_embedding``, ``position_encoding``, ``blocks.N.attn.qkv``,
``convt1``, ``conv1``, ``pred_conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import BACKBONES, MODELS
from .backbones.vit import TransformerEncoderLayer, _checkpointed
from .common import (ConvTranspose2d, Conv2d, InstanceNorm, dropout,
                     truncated_normal_)

__all__ = ["SapiensParsing"]


class SapiensParsing(nn.Module):

    def __init__(self, backbone_type: str = "sapiens_0_3b",
                 num_classes: int = 19, image_size: int = 512,
                 deconv_planes=(512, 256, 128, 64),
                 conv_planes=(64, 64, 32, 32), dropout_prob: float = 0.0,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        with torch.device("meta"):
            spec = BACKBONES.create(backbone_type, image_size=image_size)
        p, c = spec.patch_size, spec.embedding_planes
        self.dropout_prob = dropout_prob
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.patch_embedding = Conv2d(3, c, p, stride=p, dtype=dtype)
        self.position_encoding = nn.Parameter(
            torch.empty(1, (image_size // p)**2, c))
        self.blocks = nn.ModuleList(
            TransformerEncoderLayer(c, spec.head_nums, spec.feedforward_ratio,
                                    dtype=dtype)
            for _ in range(spec.block_nums))
        self.norm = InstanceNorm()
        planes = c
        for i, out in enumerate(deconv_planes):
            self.add_module(f"convt{i + 1}", ConvTranspose2d(
                planes, out, 4, 2, padding=1, bias=False))
            planes = out
        for i, out in enumerate(conv_planes):
            self.add_module(f"conv{i + 1}", Conv2d(planes, out, 1,
                                                   bias=False))
            planes = out
        self.pred_conv = Conv2d(planes, num_classes, 1)
        self.n_deconv, self.n_conv = len(deconv_planes), len(conv_planes)

    def reset_parameters(self, generator):
        truncated_normal_(self.position_encoding, 0.02, generator)

    def forward(self, x, train: bool | None = None, generator=None):
        """[B, S, S, 3] images -> [B, S, S, num_classes] f32 logits;
        ``train`` (default: the module's mode) applies the dropout."""
        if train is None:
            train = self.training
        b = x.shape[0]
        feat = self.patch_embedding(x)
        _, gh, gw, c = feat.shape
        feat = feat.reshape(b, gh * gw, c) + self.position_encoding.to(
            feat.dtype)
        feat = dropout(feat, self.dropout_prob, train, generator)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        for layer in self.blocks:
            feat = (_checkpointed(layer, feat, generator) if remat
                    else layer(feat, generator))
        y = feat.reshape(b, gh, gw, c).float()
        for i in range(self.n_deconv):
            y = F.silu(self.norm(getattr(self, f"convt{i + 1}")(y)))
        for i in range(self.n_conv):
            y = F.silu(self.norm(getattr(self, f"conv{i + 1}")(y)))
        return self.pred_conv(y)


def _register():
    for size in ("0_3b", "0_6b", "1_0b"):
        for task in ("face", "human"):

            def factory(backbone_type=f"sapiens_{size}", **kwargs):
                kwargs.pop("backbone_pretrained_path", None)
                return SapiensParsing(backbone_type=backbone_type, **kwargs)

            MODELS.register(f"sapiens_{size}_{task}_parsing")(factory)


_register()
