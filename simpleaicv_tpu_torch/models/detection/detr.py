"""DETR's sine position embedding (counterpart of
``simpleaicv_tpu/models/detection/detr.py::sine_position_embedding``);
DINO-DETR uses it. The DETR model itself is not ported yet."""

from __future__ import annotations

import math

import torch

__all__ = ["sine_position_embedding"]


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
