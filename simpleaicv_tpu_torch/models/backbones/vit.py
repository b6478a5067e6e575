"""ViT backbone family (counterpart of
``simpleaicv_tpu/models/backbones/vit.py``): pre-norm ViT with a cls token,
a learned position embedding and an optional global-pool head; variants
base/large/huge p16/p14 and sapiens 0.3b-2.0b.

Images are NHWC. Dense and conv layers compute in ``dtype`` (bf16 by
default) from f32 parameters; LayerNorms, the softmax and the head run in
f32, and the residual stream keeps the patch embedding's dtype, as in the
JAX package. Attention takes one of three paths: ``use_flash_attention``
(``ops.flash_attention.flash_attention``: the hand kernels on CUDA tensors),
``use_recompute_attention`` (``attention_recompute``), or the einsum path
that materialises the probabilities. State-dict keys are the reference
ViT's (``cls_token``, ``position_encoding``, ``patch_embedding``,
``blocks.N.norm1``, ``blocks.N.attn.qkv``, ``blocks.N.mlp.fc1``, ``norm``,
``fc``).

Dropout and drop-path masks come from the ``generator`` passed to
``forward`` (on the model's device); ``module.train()`` / ``eval()`` decide
whether they apply.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.registry import BACKBONES
from ...ops.flash_attention import attention_recompute, flash_attention
from ..common import (Conv2d, DropPath, LayerNorm, Linear, dropout,
                      truncated_normal_)

__all__ = [
    "ViT", "vit_base_patch16", "vit_large_patch16", "vit_huge_patch14",
    "vit_small_patch14", "vit_base_patch14", "vit_large_patch14",
    "vit_giant_patch14", "sapiens_0_3b", "sapiens_0_6b", "sapiens_1_0b",
    "sapiens_2_0b",
]


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, head_nums: int, dropout_prob: float = 0.0,
                 use_flash_attention: bool = False,
                 use_recompute_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.head_nums = head_nums
        self.dropout_prob = dropout_prob
        self.use_flash_attention = use_flash_attention
        self.use_recompute_attention = use_recompute_attention
        self.dtype = dtype
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x, generator=None):
        b, n, c = x.shape
        head_dim = c // self.head_nums
        qkv = self.qkv(x).reshape(b, n, 3, self.head_nums, head_dim)
        # [B, H, N, d] views of the fused projection; nothing is copied
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))

        if self.use_flash_attention and self.dropout_prob == 0.0:
            out = flash_attention(q, k, v)
        elif self.use_recompute_attention and self.dropout_prob == 0.0:
            out = attention_recompute(q, k, v)
        else:
            # products of compute-dtype operands accumulated in f32, f32
            # softmax, probabilities cast to the compute dtype before p.v
            attn = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
            attn = torch.softmax(attn * head_dim**-0.5, dim=-1)
            attn = dropout(attn, self.dropout_prob, self.training, generator)
            out = torch.einsum("bhnm,bhmd->bhnd",
                               attn.to(self.dtype).float(), v.float())
        out = out.transpose(1, 2).reshape(b, n, c).to(self.dtype)
        out = self.proj(out)
        return dropout(out, self.dropout_prob, self.training, generator)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout_prob: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x, generator=None):
        x = F.gelu(self.fc1(x), approximate="none")
        x = dropout(x, self.dropout_prob, self.training, generator)
        x = self.fc2(x)
        return dropout(x, self.dropout_prob, self.training, generator)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, dim: int, head_nums: int, feedforward_ratio: int = 4,
                 dropout_prob: float = 0.0, drop_path_prob: float = 0.0,
                 use_flash_attention: bool = False,
                 use_recompute_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stochastic = dropout_prob > 0.0 or drop_path_prob > 0.0
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, head_nums, dropout_prob,
                                       use_flash_attention,
                                       use_recompute_attention, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = FeedForward(dim, int(dim * feedforward_ratio),
                               dropout_prob, dtype)
        self.drop_path = DropPath(drop_path_prob)

    def forward(self, x, generator=None):
        h = self.attn(self.norm1(x).to(self.dtype), generator)
        x = x + self.drop_path(h.to(x.dtype), generator)
        h = self.mlp(self.norm2(x).to(self.dtype), generator)
        return x + self.drop_path(h.to(x.dtype), generator)


def _checkpointed(layer, x, generator):
    """``layer(x, generator)`` with its activations recomputed in the
    backward. The recomputation replays the generator from the state it had
    before the layer, so it draws the same masks, and then puts the
    generator back where the backward found it."""
    if generator is None or not (layer.stochastic and layer.training):
        return checkpoint(layer, x, generator, use_reentrant=False)
    before = generator.get_state()
    calls = []

    def run(x):
        if not calls:
            calls.append(1)
            return layer(x, generator)
        now = generator.get_state()
        generator.set_state(before)
        try:
            return layer(x, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False)


class ViT(nn.Module):
    """[B, S, S, 3] images -> [B, num_classes] f32 logits."""

    def __init__(self, patch_size: int, embedding_planes: int,
                 block_nums: int, head_nums: int, feedforward_ratio: int = 4,
                 image_size: int = 224, dropout_prob: float = 0.0,
                 drop_path_prob: float = 0.0, global_pool: bool = False,
                 num_classes: int = 1000,
                 use_gradient_checkpoint: bool = False,
                 use_flash_attention: bool = False,
                 use_recompute_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = embedding_planes
        self.dropout_prob = dropout_prob
        self.global_pool = global_pool
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.patch_embedding = Conv2d(3, c, patch_size, stride=patch_size,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c))
        n_tokens = (image_size // patch_size)**2 + 1
        self.position_encoding = nn.Parameter(torch.empty(1, n_tokens, c))
        self.blocks = nn.ModuleList(
            TransformerEncoderLayer(
                c, head_nums, feedforward_ratio, dropout_prob,
                0.0 if drop_path_prob == 0.0 else
                drop_path_prob * i / max(block_nums - 1, 1),
                use_flash_attention, use_recompute_attention, dtype)
            for i in range(block_nums))
        self.norm = LayerNorm(c)
        self.fc = Linear(c, num_classes, dtype=torch.float32, init_std=2e-5)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.cls_token.copy_(torch.randn(self.cls_token.shape,
                                             generator=generator) * 1e-6)
        truncated_normal_(self.position_encoding, 0.02, generator)

    def forward(self, x, generator=None):
        b = x.shape[0]
        x = self.patch_embedding(x)
        x = x.reshape(b, -1, x.shape[-1])
        cls = self.cls_token.expand(b, -1, -1).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.position_encoding.to(x.dtype)
        x = dropout(x, self.dropout_prob, self.training, generator)

        for layer in self.blocks:
            if self.use_gradient_checkpoint and torch.is_grad_enabled():
                x = _checkpointed(layer, x, generator)
            else:
                x = layer(x, generator)

        if self.global_pool:
            x = self.norm(x[:, 1:].float().mean(dim=1))
        else:
            x = self.norm(x[:, 0])  # per-token norm: only cls is used
        return self.fc(x)


def _vit(patch_size, embedding_planes, block_nums, head_nums,
         feedforward_ratio, **kwargs):
    return ViT(patch_size=patch_size, embedding_planes=embedding_planes,
               block_nums=block_nums, head_nums=head_nums,
               feedforward_ratio=feedforward_ratio, **kwargs)


@BACKBONES.register()
def vit_base_patch16(**kwargs):
    return _vit(16, 768, 12, 12, 4, **kwargs)


@BACKBONES.register()
def vit_large_patch16(**kwargs):
    return _vit(16, 1024, 24, 16, 4, **kwargs)


@BACKBONES.register()
def vit_huge_patch14(**kwargs):
    return _vit(14, 1280, 32, 16, 4, **kwargs)


@BACKBONES.register()
def vit_small_patch14(**kwargs):
    return _vit(14, 384, 12, 6, 4, **kwargs)


@BACKBONES.register()
def vit_base_patch14(**kwargs):
    return _vit(14, 768, 12, 12, 4, **kwargs)


@BACKBONES.register()
def vit_large_patch14(**kwargs):
    return _vit(14, 1024, 24, 16, 4, **kwargs)


@BACKBONES.register()
def vit_giant_patch14(**kwargs):
    return _vit(14, 1536, 40, 24, 4, **kwargs)


@BACKBONES.register()
def sapiens_0_3b(**kwargs):
    return _vit(16, 1024, 24, 16, 4, **kwargs)


@BACKBONES.register()
def sapiens_0_6b(**kwargs):
    return _vit(16, 1280, 32, 16, 4, **kwargs)


@BACKBONES.register()
def sapiens_1_0b(**kwargs):
    return _vit(16, 1536, 40, 24, 4, **kwargs)


@BACKBONES.register()
def sapiens_2_0b(**kwargs):
    return _vit(16, 1920, 48, 32, 4, **kwargs)
