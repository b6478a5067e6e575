"""MAE pretraining model (counterpart of ``simpleaicv_tpu/models/vit_mae.py``):
a ViT encoder over a random 25% of the patches with a fixed 2-D sin-cos
position embedding, a light decoder that re-inserts mask tokens, and a
per-patch pixel prediction.

Images are NHWC. The encoder and decoder blocks are the ViT's
``TransformerEncoderLayer`` on its einsum attention (the JAX model leaves
flash off); the patch embedding and ``encoder_to_decoder`` compute in
``dtype``, the norms and ``decoder_pred`` in f32.

The mask noise: the JAX model draws it from its ``mask`` rng in training
and from ``PRNGKey(0)`` in eval. The port draws it from the step's
generator in training and, in eval, from a generator on the images' device
seeded 0 (other numbers than JAX's ``PRNGKey(0)``); ``forward`` takes an
optional ``noise`` [B, L] that replaces the draw, for the tests. The
shuffle is a stable ``argsort`` of the noise.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.registry import MODELS
from .backbones.vit import TransformerEncoderLayer, _checkpointed
from .common import Conv2d, LayerNorm, Linear

__all__ = ["VITMAEPretrainModel", "sincos_2d_pos_embed",
           "vit_base_patch16_224_mae_pretrain_model",
           "vit_large_patch16_224_mae_pretrain_model",
           "vit_huge_patch14_224_mae_pretrain_model"]


def sincos_2d_pos_embed(embed_dim: int, grid_size: int,
                        cls_token: bool = True) -> np.ndarray:
    """Fixed 2-D sin-cos position encoding [1, (1+)N, C] (numpy)."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # [2, gs, gs]

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate(
        [_1d(embed_dim // 2, grid[0]), _1d(embed_dim // 2, grid[1])], axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim), np.float32), emb],
                             axis=0)
    return emb[None].astype(np.float32)


class VITMAEPretrainModel(nn.Module):
    """[B, H, W, 3] images -> (predicted patches [B, L, p*p*3] f32, mask
    [B, L] f32, 1 where a patch was masked)."""

    def __init__(self, patch_size: int = 16, image_size: int = 224,
                 mask_ratio: float = 0.75,
                 encoder_embedding_planes: int = 768,
                 encoder_block_nums: int = 12, encoder_head_nums: int = 12,
                 encoder_feedforward_ratio: int = 4,
                 encoder_dropout_prob: float = 0.0,
                 decoder_embedding_planes: int = 512,
                 decoder_block_nums: int = 8, decoder_head_nums: int = 16,
                 decoder_feedforward_ratio: int = 4,
                 decoder_dropout_prob: float = 0.0,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch_size, self.image_size = patch_size, image_size
        self.mask_ratio = mask_ratio
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.dtype = dtype
        gs = image_size // patch_size
        ce, cd = encoder_embedding_planes, decoder_embedding_planes
        self.patch_embedding = Conv2d(3, ce, patch_size, stride=patch_size,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, ce))
        self.encoder_blocks = nn.ModuleList(
            TransformerEncoderLayer(ce, encoder_head_nums,
                                    encoder_feedforward_ratio,
                                    encoder_dropout_prob, 0.0, dtype=dtype)
            for _ in range(encoder_block_nums))
        self.encoder_norm = LayerNorm(ce)
        self.encoder_to_decoder = Linear(ce, cd, dtype=dtype)
        self.mask_token = nn.Parameter(torch.empty(1, 1, cd))
        self.decoder_blocks = nn.ModuleList(
            TransformerEncoderLayer(cd, decoder_head_nums,
                                    decoder_feedforward_ratio,
                                    decoder_dropout_prob, 0.0, dtype=dtype)
            for _ in range(decoder_block_nums))
        self.decoder_norm = LayerNorm(cd)
        self.decoder_pred = Linear(cd, patch_size * patch_size * 3)
        # the fixed embeddings: numpy constants, copied once to each device
        # that asks (not module state: neither parameters nor buffers)
        self._pos = (sincos_2d_pos_embed(ce, gs), sincos_2d_pos_embed(cd, gs))
        self._pos_on = {}

    def _positions(self, device):
        if device not in self._pos_on:
            self._pos_on[device] = tuple(torch.from_numpy(a).to(device)
                                         for a in self._pos)
        return self._pos_on[device]

    def reset_parameters(self, generator):
        with torch.no_grad():
            for p in (self.cls_token, self.mask_token):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def _blocks(self, blocks, x, generator):
        for layer in blocks:
            if self.use_gradient_checkpoint and torch.is_grad_enabled():
                x = _checkpointed(layer, x, generator)
            else:
                x = layer(x, generator)
        return x

    def forward(self, images, generator=None, noise=None):
        b = images.shape[0]
        p = self.patch_size
        gs = self.image_size // p
        n_patches = gs * gs
        keep = int(n_patches * (1.0 - self.mask_ratio))
        ce = self.cls_token.shape[-1]

        encoder_pos, decoder_pos = self._positions(images.device)
        x = self.patch_embedding(images).reshape(b, n_patches, ce)
        x = x + encoder_pos[:, 1:].to(x.dtype)

        # random masking: shuffle by uniform noise, keep the first `keep`
        if noise is None:
            if not self.training:
                generator = torch.Generator(images.device).manual_seed(0)
            noise = torch.rand((b, n_patches), generator=generator,
                               device=images.device)
        shuffle_ids = torch.argsort(noise, dim=1, stable=True)
        restore_ids = torch.argsort(shuffle_ids, dim=1, stable=True)
        keep_ids = shuffle_ids[:, :keep]
        x = x.gather(1, keep_ids[:, :, None].expand(-1, -1, ce))
        mask = torch.ones((b, n_patches), device=images.device)
        mask[:, :keep] = 0.0
        mask = mask.gather(1, restore_ids)

        cls = self.cls_token.expand(b, -1, -1).to(x.dtype) \
            + encoder_pos[:, :1].to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        x = self.encoder_norm(self._blocks(self.encoder_blocks, x,
                                           generator))

        x = self.encoder_to_decoder(x.to(self.dtype))
        cd = x.shape[-1]
        masked = self.mask_token.expand(b, n_patches - keep, -1).to(x.dtype)
        patches = torch.cat([x[:, 1:], masked], dim=1)
        patches = patches.gather(1, restore_ids[:, :, None].expand(-1, -1,
                                                                    cd))
        x = torch.cat([x[:, :1], patches], dim=1)
        x = x + decoder_pos.to(x.dtype)
        x = self.decoder_norm(self._blocks(self.decoder_blocks, x,
                                           generator))
        pred = self.decoder_pred(x.float())
        return pred[:, 1:], mask

    def images_to_patch(self, images):
        """[B, H, W, 3] -> [B, L, p*p*3], rows of patches in raster order,
        each patch (row, column, channel)."""
        b, h, w, c = images.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * gw, p * p * c)

    def patch_to_images(self, x):
        b, l, _ = x.shape
        p = self.patch_size
        g = int(round(l**0.5))
        imgs = x.reshape(b, g, g, p, p, 3).permute(0, 1, 3, 2, 4, 5)
        return imgs.reshape(b, g * p, g * p, 3)


@MODELS.register()
def vit_base_patch16_224_mae_pretrain_model(**kwargs):
    return VITMAEPretrainModel(patch_size=16, encoder_embedding_planes=768,
                               encoder_block_nums=12, encoder_head_nums=12,
                               **kwargs)


@MODELS.register()
def vit_large_patch16_224_mae_pretrain_model(**kwargs):
    return VITMAEPretrainModel(patch_size=16, encoder_embedding_planes=1024,
                               encoder_block_nums=24, encoder_head_nums=16,
                               **kwargs)


@MODELS.register()
def vit_huge_patch14_224_mae_pretrain_model(**kwargs):
    return VITMAEPretrainModel(patch_size=14, encoder_embedding_planes=1280,
                               encoder_block_nums=32, encoder_head_nums=16,
                               **kwargs)
