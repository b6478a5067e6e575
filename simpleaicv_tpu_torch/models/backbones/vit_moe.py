"""ViT with Mixture-of-Experts FFN blocks (counterpart of
``simpleaicv_tpu/models/backbones/vit_moe.py``): the ViT of ``vit.py`` with
the blocks ``i % moe_every == 1`` taking a token-routed
``parallel.moe.MoEFeedForward`` in place of the dense FFN.

Everything else is the port's ViT: the patch embedding, cls token and
position embedding, the drop-path schedule, both pooling modes, the f32
head, ``use_flash_attention`` (the hand flash kernels on CUDA tensors, in
the dense and the MoE blocks alike) and per-block gradient checkpointing.
State-dict keys are the ViT's, with ``blocks.N.moe_mlp.{router, wi, bi,
wo, bo}`` in the MoE blocks. After a forward, ``parallel.moe.moe_aux_loss``
reads the blocks' auxiliary losses.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry import BACKBONES
from ...parallel.moe import MoEFeedForward
from ..common import DropPath, LayerNorm
from .vit import MultiHeadAttention, ViT

__all__ = ["ViTMoE", "vit_moe_tiny_patch16", "vit_moe_small_patch16",
           "vit_moe_base_patch16"]


class MoETransformerEncoderLayer(nn.Module):
    def __init__(self, dim: int, head_nums: int, feedforward_ratio: int = 4,
                 num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, dropout_prob: float = 0.0,
                 drop_path_prob: float = 0.0,
                 use_flash_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stochastic = dropout_prob > 0.0 or drop_path_prob > 0.0
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, head_nums, dropout_prob,
                                       use_flash_attention, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.moe_mlp = MoEFeedForward(dim, int(dim * feedforward_ratio),
                                      num_experts=num_experts, top_k=top_k,
                                      capacity_factor=capacity_factor,
                                      dtype=dtype)
        self.drop_path = DropPath(drop_path_prob)

    def forward(self, x, generator=None):
        h = self.attn(self.norm1(x).to(self.dtype), generator)
        x = x + self.drop_path(h.to(x.dtype), generator)
        h = self.moe_mlp(self.norm2(x).to(self.dtype))
        return x + self.drop_path(h.to(x.dtype), generator)


class ViTMoE(ViT):
    """[B, S, S, 3] images -> [B, num_classes] f32 logits."""

    def __init__(self, patch_size: int, embedding_planes: int,
                 block_nums: int, head_nums: int, feedforward_ratio: int = 4,
                 num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 1.25, moe_every: int = 2,
                 image_size: int = 224, dropout_prob: float = 0.0,
                 drop_path_prob: float = 0.0, global_pool: bool = False,
                 num_classes: int = 1000,
                 use_gradient_checkpoint: bool = False,
                 use_flash_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(patch_size, embedding_planes, block_nums, head_nums,
                         feedforward_ratio, image_size, dropout_prob,
                         drop_path_prob, global_pool, num_classes,
                         use_gradient_checkpoint, use_flash_attention,
                         dtype=dtype)
        self.num_experts, self.top_k = num_experts, top_k
        self.moe_every = moe_every
        for i in range(block_nums):
            if i % moe_every == 1:
                self.blocks[i] = MoETransformerEncoderLayer(
                    embedding_planes, head_nums, feedforward_ratio,
                    num_experts, top_k, capacity_factor, dropout_prob,
                    self.blocks[i].drop_path.drop_path_prob,
                    use_flash_attention, dtype)


@BACKBONES.register()
def vit_moe_tiny_patch16(**kwargs):
    return ViTMoE(patch_size=16, embedding_planes=192, block_nums=12,
                  head_nums=3, **kwargs)


@BACKBONES.register()
def vit_moe_small_patch16(**kwargs):
    return ViTMoE(patch_size=16, embedding_planes=384, block_nums=12,
                  head_nums=6, **kwargs)


@BACKBONES.register()
def vit_moe_base_patch16(**kwargs):
    return ViTMoE(patch_size=16, embedding_planes=768, block_nums=12,
                  head_nums=12, **kwargs)
