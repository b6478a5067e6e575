"""SAM mask decoder and two-way transformer (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/mask_decoder.py``).

IoU and mask tokens, two two-way blocks, hypernetwork mask heads and the
IoU prediction MLP, all in f32. Image embeddings are NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common import ConvTranspose2d, LayerNorm, Linear
from .image_encoder import LayerNormChannelsLast

__all__ = ["MaskDecoder", "TwoWayTransformer"]


class Attention(nn.Module):
    def __init__(self, dim: int, head_nums: int, downsample_rate: int = 1):
        super().__init__()
        inter = dim // downsample_rate
        self.head_nums = head_nums
        self.q_proj = Linear(dim, inter)
        self.k_proj = Linear(dim, inter)
        self.v_proj = Linear(dim, inter)
        self.out_proj = Linear(inter, dim)

    def forward(self, q, k, v):
        def heads(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.head_nums,
                             c // self.head_nums).transpose(1, 2)

        qh, kh, vh = heads(self.q_proj(q)), heads(self.k_proj(k)), \
            heads(self.v_proj(v))
        head_dim = qh.shape[-1]
        attn = torch.einsum("bhnd,bhmd->bhnm", qh, kh)
        attn = torch.softmax(attn / head_dim**0.5, dim=-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, vh)
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, -1))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_planes: int = 2048):
        super().__init__()
        self.lin1 = Linear(dim, mlp_planes)
        self.lin2 = Linear(mlp_planes, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, head_nums: int, mlp_planes: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(dim, head_nums)
        self.norm1 = LayerNorm(dim)
        self.cross_attn_token_to_image = Attention(dim, head_nums,
                                                   attention_downsample_rate)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_planes)
        self.norm3 = LayerNorm(dim)
        self.norm4 = LayerNorm(dim)
        self.cross_attn_image_to_token = Attention(dim, head_nums,
                                                   attention_downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.norm2(queries)

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = self.norm4(keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int, block_nums: int = 2, head_nums: int = 8,
                 mlp_planes: int = 2048, attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, head_nums, mlp_planes,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(block_nums))
        self.final_attn_token_to_image = Attention(dim, head_nums,
                                                   attention_downsample_rate)
        self.norm_final_attn = LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe [B, H, W, C]; point_embedding
        [B, N, C]."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, c).expand_as(keys)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class MLP(nn.Module):
    def __init__(self, in_planes: int, hidden_planes: int, planes: int,
                 layer_nums: int):
        super().__init__()
        dims = [in_planes] + [hidden_planes] * (layer_nums - 1) + [planes]
        self.layers = nn.ModuleList(Linear(i, o)
                                    for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, inplanes: int = 256, num_multimask_outputs: int = 3,
                 iou_prediction_head_block_nums: int = 3,
                 iou_prediction_head_hidden_planes: int = 256):
        super().__init__()
        n_tokens = num_multimask_outputs + 1
        self.n_tokens = n_tokens
        self.iou_token = nn.Parameter(torch.empty(1, inplanes))
        self.mask_tokens = nn.Parameter(torch.empty(n_tokens, inplanes))
        self.transformer = TwoWayTransformer(inplanes)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2d(inplanes, inplanes // 4, 2, stride=2),
            LayerNormChannelsLast(inplanes // 4), nn.GELU(approximate="none"),
            ConvTranspose2d(inplanes // 4, inplanes // 8, 2, stride=2),
            nn.GELU(approximate="none"))
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(inplanes, inplanes, inplanes // 8, 3) for _ in range(n_tokens))
        self.iou_prediction_head = MLP(
            inplanes, iou_prediction_head_hidden_planes, n_tokens,
            iou_prediction_head_block_nums)

    def reset_parameters(self, generator):
        for p in (self.iou_token, self.mask_tokens):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator))

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings,
                mask_out_idxs: Sequence[int] = (0, 1, 2, 3),
                return_feats: bool = False):
        """image_embeddings [B, H, W, C]; returns (masks [B, K, 4H, 4W],
        iou [B, K]) for the K tokens in ``mask_out_idxs`` and, with
        ``return_feats``, the upscaled mask feature [B, 4H, 4W, C/8] too."""
        bp = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        output_tokens = output_tokens[None].expand(bp, -1, -1)
        tokens = torch.cat([output_tokens, sparse_prompt_embeddings], dim=1)

        src = image_embeddings.float()
        if src.shape[0] != bp:
            src = src.repeat_interleave(bp // src.shape[0], dim=0)
        src = src + dense_prompt_embeddings
        b, h, w, c = src.shape

        hs, src = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.n_tokens]

        upscaled = self.output_upscaling(src.reshape(b, h, w, c))
        hyper = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bkc,bhwc->bkhw", hyper, upscaled)
        iou_pred = self.iou_prediction_head(iou_token_out)
        idxs = list(mask_out_idxs)
        if return_feats:
            return masks[:, idxs], iou_pred[:, idxs], upscaled
        return masks[:, idxs], iou_pred[:, idxs]
