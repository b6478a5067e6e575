"""SAM prompt encoder (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/prompt_encoder.py``).

Random-Fourier point and box embeddings, the mask-downscaling path and the
no-mask embedding, all in f32. Point prompts arrive as [B, N, 3]
(x, y, label) with label -1 for padding ("not a point").
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..common import Conv2d
from .image_encoder import LayerNormChannelsLast

__all__ = ["PromptEncoder", "PositionEmbeddingRandom"]


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.empty(2, num_pos_feats))

    def reset_parameters(self, generator):
        self.positional_encoding_gaussian_matrix.copy_(torch.randn(
            self.positional_encoding_gaussian_matrix.shape,
            generator=generator))

    def _pe(self, coords):
        coords = 2.0 * coords - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid_pe(self, size: int):
        """[H, W, C] dense positional encoding."""
        device = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(size, dtype=torch.float32, device=device)
              + 0.5) / size
        xs = (torch.arange(size, dtype=torch.float32, device=device)
              + 0.5) / size
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self._pe(grid)

    def coords_pe(self, coords, image_size: int):
        return self._pe(coords.float() / image_size)


class PromptEncoder(nn.Module):
    def __init__(self, image_size: int = 1024, patch_size: int = 16,
                 embedding_planes: int = 256, mask_inter_planes: int = 16):
        super().__init__()
        self.image_size = image_size
        self.image_embedding_size = image_size // patch_size
        self.embedding_planes = embedding_planes
        self.pe_layer = PositionEmbeddingRandom(embedding_planes // 2)
        self.point_embeddings = nn.Parameter(torch.empty(4, embedding_planes))
        self.not_a_point_embed = nn.Parameter(torch.empty(embedding_planes))
        self.no_mask_embed = nn.Parameter(torch.empty(embedding_planes))
        q = mask_inter_planes
        self.mask_downscaling = nn.Sequential(
            Conv2d(1, q // 4, 2, stride=2), LayerNormChannelsLast(q // 4),
            nn.GELU(approximate="none"), Conv2d(q // 4, q, 2, stride=2),
            LayerNormChannelsLast(q), nn.GELU(approximate="none"),
            Conv2d(q, embedding_planes, 1))

    def reset_parameters(self, generator):
        for p in (self.point_embeddings, self.not_a_point_embed,
                  self.no_mask_embed):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator))

    def embed_points(self, points, pad: bool):
        """points [B, N, 3] (x, y, label; -1 pad / 0 negative / 1 positive)."""
        coords = points[..., 0:2] + 0.5
        labels = points[..., 2]
        if pad:
            b = points.shape[0]
            coords = torch.cat([coords, coords.new_zeros(b, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        pe = self.pe_layer.coords_pe(coords, self.image_size)
        lab = labels[..., None]
        pe = torch.where(lab == -1, 0.0, pe)
        pe = pe + torch.where(lab == -1, self.not_a_point_embed, 0.0)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0], 0.0)
        pe = pe + torch.where(lab == 1, self.point_embeddings[1], 0.0)
        return pe

    def embed_boxes(self, boxes):
        """boxes [B, 4] or [B, 1, 4]."""
        boxes = boxes.reshape(boxes.shape[0], -1)[:, :4] + 0.5
        pe = self.pe_layer.coords_pe(boxes.reshape(-1, 2, 2), self.image_size)
        corner = torch.stack([self.point_embeddings[2],
                              self.point_embeddings[3]])
        return pe + corner

    def embed_masks(self, masks):
        """masks [B, H, W, 1] at 4x the image-embedding resolution."""
        return self.mask_downscaling(masks.float())

    def forward(self, points=None, boxes=None, masks=None):
        if points is not None:
            batch, device = points.shape[0], points.device
        elif boxes is not None:
            batch, device = boxes.shape[0], boxes.device
        else:
            batch, device = masks.shape[0], masks.device
        sparse = torch.zeros(batch, 0, self.embedding_planes, device=device)
        if points is not None:
            sparse = torch.cat(
                [sparse, self.embed_points(points, pad=boxes is None)], dim=1)
        if boxes is not None:
            sparse = torch.cat([sparse, self.embed_boxes(boxes)], dim=1)
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            s = self.image_embedding_size
            dense = self.no_mask_embed.reshape(1, 1, 1, -1).expand(
                batch, s, s, self.embedding_planes)
        return sparse, dense

    def get_dense_pe(self):
        return self.pe_layer.grid_pe(self.image_embedding_size)[None]

