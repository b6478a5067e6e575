"""The DDPM UNet (counterpart of ``simpleaicv_tpu/models/diffusion_unet.py``),
in f32 throughout as the JAX model computes it.

A sinusoidal time embedding through two linear layers; an optional class
embedding of ``num_classes + 1`` rows (row 0 the unconditional token,
embedded as zeros) through two more; ResBlocks of GroupNorm, SiLU and 3x3
convolutions with the time (and class) projections added and dropout from
an explicit generator, each optionally followed by a single-head
self-attention block over the h x w tokens (an f32 einsum, as in the JAX
model, not the flash kernel); stride-2 convolutions down (after a
bottom-right pad of 1), nearest 2x upsamples and 3x3 convolutions up, with
the skip connections concatenated. NHWC. Sub-modules carry the JAX names
(``down_0``, ``down_2_conv``, ``middle_0``, ``up_3_conv``, ...), so the
state-dict keys are the JAX paths.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import MODELS
from ..ops.upsample import upsample_nearest_2x
from .common import Conv2d, Embed, GroupNorm, Linear, checkpoint, dropout

__all__ = ["DiffusionUNet", "time_embedding"]


def time_embedding(t, planes: int):
    """[B] time steps -> [B, planes] f32 sinusoids (sin half, then cos)."""
    half = planes // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=t.device)
                     * math.log(10000.0) / (half - 1))
    emb = t.float()[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if planes % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _conv(in_planes, planes, k=3, stride=1, padding=None):
    return Conv2d(in_planes, planes, k, stride,
                  (k - 1) // 2 if padding is None else padding,
                  dtype=torch.float32)


class AttentionBlock(nn.Module):

    def __init__(self, planes: int, num_groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(num_groups, planes)
        self.q = _conv(planes, planes, 1)
        self.k = _conv(planes, planes, 1)
        self.v = _conv(planes, planes, 1)
        self.proj_out = _conv(planes, planes, 1)

    def forward(self, x):
        b, h, w, c = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, h * w, c)
        k = self.k(hn).reshape(b, h * w, c)
        v = self.v(hn).reshape(b, h * w, c)
        attn = torch.einsum("bnc,bmc->bnm", q, k) * (c ** -0.5)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bnm,bmc->bnc", attn, v)
        return x + self.proj_out(out.reshape(b, h, w, c))


class ResBlock(nn.Module):

    def __init__(self, inplanes: int, planes: int, time_planes: int,
                 num_groups: int = 32, has_class: bool = False,
                 dropout_prob: float = 0.0, use_attention: bool = False):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, inplanes)
        self.conv1 = _conv(inplanes, planes)
        self.time_proj = Linear(time_planes, planes)
        self.class_proj = Linear(time_planes, planes) if has_class else None
        self.norm2 = GroupNorm(num_groups, planes)
        self.conv2 = _conv(planes, planes)
        self.nin_shortcut = (_conv(inplanes, planes, 1)
                             if inplanes != planes else None)
        self.attention = (AttentionBlock(planes, num_groups)
                          if use_attention else None)
        self.dropout_prob = dropout_prob

    def forward(self, x, emb_time, emb_class, train: bool = False,
                generator=None):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_proj(F.silu(emb_time))[:, None, None, :]
        if self.class_proj is not None and emb_class is not None:
            h = h + self.class_proj(F.silu(emb_class))[:, None, None, :]
        h = F.silu(self.norm2(h))
        h = dropout(h, self.dropout_prob, train, generator)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        x = x + h
        if self.attention is not None:
            x = self.attention(x)
        return x


class DiffusionUNet(nn.Module):
    """(x [B, H, W, inplanes], t [B], class labels [B] or None) ->
    predicted noise [B, H, W, inplanes] f32."""

    def __init__(self, inplanes: int = 3, planes: int = 128,
                 planes_multi: Sequence[int] = (1, 2, 2, 2),
                 time_embedding_ratio: int = 4, block_nums: int = 2,
                 dropout_prob: float = 0.0, num_groups: int = 32,
                 use_attention_planes_multi_idx: Sequence[int] = (0, 1, 2, 3),
                 num_classes: Optional[int] = None,
                 use_gradient_checkpoint: bool = False):
        super().__init__()
        self.planes = planes
        self.num_classes = num_classes
        self.use_gradient_checkpoint = use_gradient_checkpoint
        time_planes = planes * time_embedding_ratio
        self.time_mlp_1 = Linear(planes, time_planes)
        self.time_mlp_2 = Linear(time_planes, time_planes)
        if num_classes:
            self.class_embed = Embed(num_classes + 1, planes)
            self.class_mlp_1 = Linear(planes, time_planes)
            self.class_mlp_2 = Linear(time_planes, time_planes)
        block = dict(time_planes=time_planes, num_groups=num_groups,
                     has_class=bool(num_classes), dropout_prob=dropout_prob)

        self.stem = _conv(inplanes, planes)
        # the forward's plan: ("block", name) or ("down" | "up", name)
        self.plan = []
        skips = [planes]
        cur, n_levels, bidx = planes, len(planes_multi), 0
        for idx, mult in enumerate(planes_multi):
            per = int(planes * mult)
            for _ in range(block_nums):
                self._add(f"down_{bidx}", "block", ResBlock(
                    cur, per, use_attention=(
                        idx in use_attention_planes_multi_idx), **block))
                cur = per
                bidx += 1
                skips.append(cur)
            if idx != n_levels - 1:
                self._add(f"down_{bidx}_conv", "down",
                          _conv(cur, cur, 3, 2, padding=0))
                bidx += 1
                skips.append(cur)
        self._add("middle_0", "block",
                  ResBlock(cur, cur, use_attention=True, **block))
        self._add("middle_1", "block",
                  ResBlock(cur, cur, use_attention=False, **block))
        up_attn_idx = [n_levels - 1 - i
                       for i in use_attention_planes_multi_idx]
        bidx = 0
        for idx in reversed(range(n_levels)):
            per = int(planes * planes_multi[idx])
            for _ in range(block_nums + 1):
                self._add(f"up_{bidx}", "skip_block", ResBlock(
                    cur + skips.pop(), per,
                    use_attention=(idx in up_attn_idx), **block))
                cur = per
                bidx += 1
            if idx != 0:
                self._add(f"up_{bidx}_conv", "up", _conv(cur, cur, 3))
                bidx += 1
        assert not skips
        self.last_norm = GroupNorm(num_groups, cur)
        self.last_conv = _conv(cur, inplanes)

    def _add(self, name, kind, module):
        self.add_module(name, module)
        self.plan.append((kind, name))

    def _block(self, name, x, emb, emb_class, train, generator):
        block = getattr(self, name)
        if self.use_gradient_checkpoint and train:
            return checkpoint(lambda *a: block(*a, train, generator), x, emb,
                              emb_class)
        return block(x, emb, emb_class, train, generator)

    def forward(self, x, t, class_label=None, train: bool | None = None,
                generator=None):
        """``train`` defaults to the module's mode; dropout draws from
        ``generator``."""
        if train is None:
            train = self.training
        emb = self.time_mlp_1(time_embedding(t, self.planes))
        emb = self.time_mlp_2(F.silu(emb))
        emb_class = None
        if self.num_classes and class_label is not None:
            ce = self.class_embed(class_label.long())
            ce = torch.where((class_label == 0)[:, None], 0.0, ce)
            ce = self.class_mlp_1(ce)
            emb_class = self.class_mlp_2(F.silu(ce))

        x = self.stem(x.float())
        skips = [x]
        for kind, name in self.plan:
            if kind == "block":
                x = self._block(name, x, emb, emb_class, train, generator)
                if name.startswith("down"):
                    skips.append(x)
            elif kind == "down":
                x = getattr(self, name)(F.pad(x, (0, 0, 0, 1, 0, 1)))
                skips.append(x)
            elif kind == "skip_block":
                x = torch.cat([x, skips.pop()], dim=-1)
                x = self._block(name, x, emb, emb_class, train, generator)
            else:
                x = getattr(self, name)(upsample_nearest_2x(x))
        x = self.last_norm(x)
        return self.last_conv(F.silu(x))


MODELS.register("DiffusionUNet")(lambda **kw: DiffusionUNet(**kw))
