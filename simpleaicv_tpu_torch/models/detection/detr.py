"""DETR (counterpart of ``simpleaicv_tpu/models/detection/detr.py``): a
post-norm transformer of ``encoder_layer_nums`` + ``decoder_layer_nums``
layers over a ResNet's C5 with the sine position embedding and key-padding
masks, ``query_nums`` learned queries, and class and box heads on every
decoder layer's output (sigmoid cxcywh boxes). Its attention is plain
PyTorch: DETR runs no hand kernel.

Images are NHWC. The backbone computes in ``dtype`` (bf16 by default); the
rest in f32, as in the JAX package. State-dict keys are the JAX tree's
paths with ``_N`` written ``.N``: ``proj_conv``,
``encoder.0.attention.q``, ``decoder.5.multihead_attention.out``,
``query_embed``, ``decoder_norm``, ``cls_head``, ``reg_head.1``,
``reg_head_out``. ``sine_position_embedding`` serves DINO-DETR too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES, MODELS
from ..common import Conv2d, LayerNorm, Linear, dropout

__all__ = ["sine_position_embedding", "MHA", "EncoderLayer", "DecoderLayer",
           "DETR", "resnet18_detr", "resnet34_detr", "resnet50_detr",
           "resnet101_detr", "resnet152_detr"]


def sine_position_embedding(mask, planes: int, temperature: float = 10000.0,
                            eps: float = 1e-6):
    """mask [B, H, W] (true or 1 = padding) -> [B, H, W, 2 * planes] f32:
    the y embedding's ``planes`` channels, then the x embedding's."""
    not_mask = 1.0 - mask.float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(planes, dtype=torch.float32, device=mask.device)
    dim_t = temperature**(2 * (dim_t // 2) / planes)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(*pos_x.shape[:-1], -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(*pos_y.shape[:-1], -1)
    return torch.cat([pos_y, pos_x], dim=-1)


class MHA(nn.Module):
    """Multi-head attention in f32 with q, k, v and out projections.
    ``key_padding_mask`` [B, Nk] (1 = padding) is ADDED to the logits, as
    the reference's float mask is in ``nn.MultiheadAttention``; dropout on
    the attention weights in training, from ``generator``."""

    def __init__(self, dim: int, head_nums: int = 8,
                 dropout_prob: float = 0.1):
        super().__init__()
        self.head_nums, self.dropout_prob = head_nums, dropout_prob
        self.q, self.k = Linear(dim, dim), Linear(dim, dim)
        self.v, self.out = Linear(dim, dim), Linear(dim, dim)

    def forward(self, q, k, v, key_padding_mask=None, train: bool = False,
                generator=None):
        b, nq, c = q.shape
        h = self.head_nums
        qh = self.q(q).reshape(b, nq, h, c // h)
        kh = self.k(k).reshape(b, k.shape[1], h, c // h)
        vh = self.v(v).reshape(b, v.shape[1], h, c // h)
        attn = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * (c // h)**-0.5
        if key_padding_mask is not None:
            attn = attn + key_padding_mask.float()[:, None, None, :]
        attn = dropout(attn.softmax(-1), self.dropout_prob, train, generator)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, vh).reshape(b, nq, c)
        return self.out(out)


class EncoderLayer(nn.Module):

    def __init__(self, dim: int, head_nums: int = 8,
                 feedforward_ratio: int = 4, dropout_prob: float = 0.1):
        super().__init__()
        self.attention = MHA(dim, head_nums, dropout_prob)
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.linear1 = Linear(dim, dim * feedforward_ratio)
        self.linear2 = Linear(dim * feedforward_ratio, dim)

    def forward(self, src, pos, key_padding_mask, train=False,
                generator=None):
        q = src + pos
        src = self.norm1(src + self.attention(q, q, src, key_padding_mask,
                                              train, generator))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):

    def __init__(self, dim: int, head_nums: int = 8,
                 feedforward_ratio: int = 4, dropout_prob: float = 0.1):
        super().__init__()
        self.attention = MHA(dim, head_nums, dropout_prob)
        self.multihead_attention = MHA(dim, head_nums, dropout_prob)
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.linear1 = Linear(dim, dim * feedforward_ratio)
        self.linear2 = Linear(dim * feedforward_ratio, dim)

    def forward(self, tgt, memory, query_pos, pos, key_padding_mask,
                train=False, generator=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.attention(q, q, tgt, None, train,
                                              generator))
        tgt = self.norm2(tgt + self.multihead_attention(
            tgt + query_pos, memory + pos, memory, key_padding_mask, train,
            generator))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class DETR(nn.Module):
    """``forward(x, masks=None, train=False, generator=None)``: x
    [B, H, W, 3]; masks [B, H, W] (1 = padding; None: no padding). Returns
    [cls [L, B, Q, num_classes + 1], boxes [L, B, Q, 4]] for the L decoder
    layers, each layer's output through the shared ``decoder_norm``."""

    def __init__(self, backbone_type: str, hidden_inplanes: int = 256,
                 query_nums: int = 100, num_classes: int = 80,
                 encoder_layer_nums: int = 6, decoder_layer_nums: int = 6,
                 head_nums: int = 8, dropout_prob: float = 0.1,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = hidden_inplanes
        self.hidden_inplanes = c
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True, dtype=dtype,
            use_gradient_checkpoint=use_gradient_checkpoint)
        self.proj_conv = Conv2d(self.backbone.feature_channels[-1], c, 1)
        self.encoder = nn.ModuleList(
            EncoderLayer(c, head_nums, 4, dropout_prob)
            for _ in range(encoder_layer_nums))
        self.query_embed = nn.Parameter(torch.empty(query_nums, c))
        self.decoder = nn.ModuleList(
            DecoderLayer(c, head_nums, 4, dropout_prob)
            for _ in range(decoder_layer_nums))
        self.decoder_norm = LayerNorm(c)
        self.cls_head = Linear(c, num_classes + 1)
        self.reg_head = nn.ModuleList(Linear(c, c) for _ in range(2))
        self.reg_head_out = Linear(c, 4)

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.query_embed.copy_(torch.randn(self.query_embed.shape,
                                               generator=generator))

    def forward(self, x, masks=None, train: bool = False, generator=None):
        if masks is None:
            masks = torch.zeros(x.shape[:3], device=x.device)
        feat = self.backbone(x, train)[-1]
        b, h, w, _ = feat.shape
        c = self.hidden_inplanes
        # F.interpolate's nearest: source row floor(dst * in / out)
        hidx = torch.arange(h, device=x.device) * masks.shape[1] // h
        widx = torch.arange(w, device=x.device) * masks.shape[2] // w
        m = masks[:, hidx][:, :, widx] > 0.5
        pos = sine_position_embedding(m, c // 2).reshape(b, h * w, c)
        src = self.proj_conv(feat.float()).reshape(b, h * w, c)
        pad = m.reshape(b, h * w)
        for layer in self.encoder:
            src = layer(src, pos, pad, train, generator)

        query_pos = self.query_embed[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos)
        inter = []
        for layer in self.decoder:
            tgt = layer(tgt, src, query_pos, pos, pad, train, generator)
            inter.append(self.decoder_norm(tgt))
        hs = torch.stack(inter, 0)
        reg = hs
        for head in self.reg_head:
            reg = F.relu(head(reg))
        return [self.cls_head(hs), torch.sigmoid(self.reg_head_out(reg))]


def _detr(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return DETR(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_detr(**kwargs):
    return _detr("resnet18", **kwargs)


@MODELS.register()
def resnet34_detr(**kwargs):
    return _detr("resnet34", **kwargs)


@MODELS.register()
def resnet50_detr(**kwargs):
    return _detr("resnet50", **kwargs)


@MODELS.register()
def resnet101_detr(**kwargs):
    return _detr("resnet101", **kwargs)


@MODELS.register()
def resnet152_detr(**kwargs):
    return _detr("resnet152", **kwargs)
