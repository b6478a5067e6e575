"""SAM ViT image encoder (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/image_encoder.py``).

Patch embedding plus a learned position embedding, windowed (14x14)
attention with a decomposed relative-position bias, global-attention layers,
and a conv neck with channels-last LayerNorms. Tensors stay NHWC. Dense and
conv layers compute in ``dtype`` (bf16 by default); LayerNorms and the
softmax run in f32, as in the JAX package.

Global layers whose token count is a multiple of 128 take
``flash_attention_relpos`` when ``use_flash_attention`` is set: the hand
kernel on CUDA tensors. Every other layer takes the einsum path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import flash_attention_relpos
from ...ops.upsample import resize_bilinear
from ..common import Conv2d, LayerNorm, Linear

__all__ = ["ViTImageEncoder", "window_partition", "window_unpartition",
           "get_rel_pos", "add_decomposed_rel_pos"]


def window_partition(x, window_size: int):
    """[B, H, W, C] -> ([B * nW, ws, ws, C], (Hp, Wp)), zero-padding H and W
    up to multiples of ``window_size`` (SAM's 64x64 grid pads to 70)."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size,
                  window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                  window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size,
                        window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """Slices the [2*max(q,k)-1, C] rel-pos table by relative coordinates,
    linearly resizing the table first when its length differs."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_bilinear(rel_pos[None],
                                  (max_rel_dist, rel_pos.shape[1]))[0]
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """attn [B, q_h*q_w, k_h*k_w] + rel_h[.., k_h] + rel_w[.., k_w], with
    both terms built in f32 from ``q`` [B, q_h*q_w, C]."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim).float()
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh.float())
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw.float())
    attn = attn.reshape(b, q_h, q_w, k_h, k_w)
    attn = attn + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(b, q_h * q_w, k_h * k_w)


class RelPosAttention(nn.Module):
    def __init__(self, dim: int, head_nums: int, input_size: Tuple[int, int],
                 use_flash_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.head_nums = head_nums
        self.use_flash_attention = use_flash_attention
        self.dtype = dtype
        head_dim = dim // head_nums
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * input_size[1] - 1,
                                                  head_dim))

    def reset_parameters(self, generator):
        # flax initialises these tables to zeros; random weights draw them
        # non-zero so that a run with them exercises the bias path
        for p in (self.rel_pos_h, self.rel_pos_w):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def forward(self, x):
        b, h, w, c = x.shape
        heads = self.head_nums
        head_dim = c // heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * heads, h * w,
                                                 head_dim)
        q, k, v = qkv.unbind(0)

        n = h * w
        if self.use_flash_attention and n % 128 == 0:
            rh = get_rel_pos(h, h, self.rel_pos_h)
            rw = get_rel_pos(w, w, self.rel_pos_w)
            r_q = q.float().reshape(-1, h, w, head_dim)
            rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
            rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
            out, _ = flash_attention_relpos(
                q.contiguous(), k.contiguous(), v.contiguous(),
                rel_h.reshape(-1, n, h), rel_w.reshape(-1, n, w))
        else:
            # q is scaled in its own dtype before q.k, the rel-pos terms
            # come from the unscaled f32 q, products accumulate in f32 and
            # the probabilities are cast to the compute dtype before p.v
            attn = torch.einsum("bnd,bmd->bnm",
                                (q * head_dim**-0.5).float(), k.float())
            attn = add_decomposed_rel_pos(attn, q.float(), self.rel_pos_h,
                                          self.rel_pos_w, (h, w), (h, w))
            attn = torch.softmax(attn, dim=-1).to(self.dtype)
            out = torch.einsum("bnm,bmd->bnd", attn.float(), v.float())
        out = out.reshape(b, heads, h, w, head_dim)
        out = out.permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.proj(out.to(self.dtype))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim, dtype=dtype)
        self.lin2 = Linear(mlp_dim, dim, dtype=dtype)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, head_nums: int, mlp_ratio: float = 4.0,
                 input_size: Tuple[int, int] = (64, 64), window_size: int = 0,
                 use_flash_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.window_size = window_size
        self.dtype = dtype
        attn_size = ((window_size, window_size) if window_size > 0
                     else input_size)
        self.norm1 = LayerNorm(dim)
        self.attn = RelPosAttention(dim, head_nums, attn_size,
                                    use_flash_attention, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        shortcut = x
        h = self.norm1(x).to(self.dtype)
        if self.window_size > 0:
            hh, ww = h.shape[1], h.shape[2]
            h, pad_hw = window_partition(h, self.window_size)
        h = self.attn(h)
        if self.window_size > 0:
            h = window_unpartition(h, self.window_size, pad_hw, (hh, ww))
        x = shortcut + h.to(shortcut.dtype)
        h = self.mlp(self.norm2(x).to(self.dtype))
        return x + h.to(x.dtype)


class LayerNormChannelsLast(nn.Module):
    """The reference's LayerNorm2d over NHWC channels, in f32, eps 1e-6."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.float()
        u = x.mean(-1, keepdim=True)
        s = ((x - u) ** 2).mean(-1, keepdim=True)
        return (x - u) * torch.rsqrt(s + 1e-6) * self.weight + self.bias


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embedding_planes: int,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = Conv2d(3, embedding_planes, patch_size, stride=patch_size,
                           dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class ViTImageEncoder(nn.Module):
    """[B, S, S, 3] images -> [B, S/16, S/16, out_planes] f32 embeddings."""

    def __init__(self, image_size: int = 1024, patch_size: int = 16,
                 embedding_planes: int = 768, block_nums: int = 12,
                 head_nums: int = 12, mlp_ratio: float = 4.0,
                 out_planes: int = 256, window_size: int = 0,
                 global_attn_indexes: Sequence[int] = (),
                 use_flash_attention: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        g = image_size // patch_size
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embedding_planes, dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, g, g, embedding_planes))
        self.blocks = nn.ModuleList(
            EncoderBlock(embedding_planes, head_nums, mlp_ratio, (g, g),
                         window_size if i not in global_attn_indexes else 0,
                         use_flash_attention, dtype)
            for i in range(block_nums))
        self.neck = nn.Sequential(
            Conv2d(embedding_planes, out_planes, 1, bias=False, dtype=dtype),
            LayerNormChannelsLast(out_planes),
            Conv2d(out_planes, out_planes, 3, padding=1, bias=False,
                   dtype=dtype),
            LayerNormChannelsLast(out_planes))

    def reset_parameters(self, generator):
        # zeros in flax; non-zero here for the same reason as rel_pos_h/w
        with torch.no_grad():
            self.pos_embed.copy_(
                torch.randn(self.pos_embed.shape, generator=generator) * 0.02)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)
