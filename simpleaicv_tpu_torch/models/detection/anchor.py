"""Anchor and position generation (a copy of
``simpleaicv_tpu/models/detection/anchor.py``, numpy only): RetinaNet's
anchors, [H, W, A, 4] xyxy per level, and FCOS's cell centres, [H, W, 2]
per level, both at ``(i + 0.5) * stride``. The losses and decoders turn
them into tensors on the predictions' device (``OnDevice``); the helpers
at the end flatten per-level predictions in the same order and decode
regressions against anchors."""

from __future__ import annotations

import math

import numpy as np
import torch


class RetinaAnchors:

    def __init__(self,
                 areas=((32, 32), (64, 64), (128, 128), (256, 256),
                        (512, 512)),
                 ratios=(0.5, 1, 2),
                 scales=(2**0, 2**(1.0 / 3.0), 2**(2.0 / 3.0)),
                 strides=(8, 16, 32, 64, 128)):
        self.areas = np.array(areas, np.float32)
        self.ratios = np.array(ratios, np.float32)
        self.scales = np.array(scales, np.float32)
        self.strides = np.array(strides, np.float32)

    def __call__(self, fpn_feature_sizes):
        """fpn_feature_sizes: [[W,H], ...] per level -> list of [H,W,A,4]
        xyxy anchors."""
        out = []
        for idx, area in enumerate(self.areas):
            base = self.generate_base_anchors(area, self.scales, self.ratios)
            out.append(self.generate_anchors_on_feature_map(
                base, fpn_feature_sizes[idx], self.strides[idx]))
        return out

    def generate_base_anchors(self, area, scales, ratios):
        aspects = np.array([[[s * math.sqrt(r), s * math.sqrt(1 / r)]
                             for s in scales] for r in ratios],
                           np.float32).reshape(-1, 2)
        base = np.zeros((len(scales) * len(ratios), 4), np.float32)
        wh = area * aspects
        base[:, 2:] += wh
        base[:, 0] -= base[:, 2] / 2
        base[:, 1] -= base[:, 3] / 2
        base[:, 2] /= 2
        base[:, 3] /= 2
        return base

    def generate_anchors_on_feature_map(self, base_anchors, fm_size, stride):
        w, h = int(fm_size[0]), int(fm_size[1])
        sx = (np.arange(w, dtype=np.float32) + 0.5) * stride
        sy = (np.arange(h, dtype=np.float32) + 0.5) * stride
        shift = np.stack(np.meshgrid(sx, sy), axis=-1)  # [h,w,2]
        shift = np.tile(shift, (1, 1, 2))[:, :, None, :]  # [h,w,1,4]
        return (base_anchors[None, None] + shift).astype(np.float32)

    def flat_anchors(self, fpn_feature_sizes) -> np.ndarray:
        """All levels concatenated: [sum(H*W*A), 4]."""
        return np.concatenate(
            [a.reshape(-1, 4) for a in self(fpn_feature_sizes)], axis=0)


class FCOSPositions:

    def __init__(self, strides=(8, 16, 32, 64, 128)):
        self.strides = np.array(strides, np.float32)

    def __call__(self, fpn_feature_sizes):
        out = []
        for stride, fm in zip(self.strides, fpn_feature_sizes):
            w, h = int(fm[0]), int(fm[1])
            sx = (np.arange(w, dtype=np.float32) + 0.5) * stride
            sy = (np.arange(h, dtype=np.float32) + 0.5) * stride
            out.append(np.stack(np.meshgrid(sx, sy), axis=-1).astype(
                np.float32))  # [h,w,2]
        return out

    def flat_positions_strides(self, fpn_feature_sizes):
        """-> ([P,2] positions, [P] strides)."""
        pos_levels = self(fpn_feature_sizes)
        pos = np.concatenate([p.reshape(-1, 2) for p in pos_levels], axis=0)
        strides = np.concatenate([
            np.full((p.shape[0] * p.shape[1],), s, np.float32)
            for p, s in zip(pos_levels, self.strides)
        ])
        return pos, strides


class OnDevice:
    """The arrays of ``make(feature_sizes)`` (a tuple of numpy arrays) as
    tensors on a device, made once per (feature sizes, device): a copy
    from pageable host memory would wait for the card at every step."""

    def __init__(self, make):
        self.make = make
        self.cache = {}

    def __call__(self, feature_sizes, device):
        key = (tuple(tuple(int(v) for v in fs) for fs in feature_sizes),
               str(device))
        if key not in self.cache:
            self.cache[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in self.make(feature_sizes))
        return self.cache[key]


def feature_sizes(levels):
    """[[w, h], ...] of per-level NHWC predictions."""
    return [[p.shape[2], p.shape[1]] for p in levels]


def flatten_levels(levels, width: int):
    """Per-level [B, ..., width] predictions -> [B, N, width], level by
    level (the anchors' and points' order)."""
    b = levels[0].shape[0]
    return torch.cat([p.reshape(b, -1, width) for p in levels], dim=1)


def anchor_boxes(reg, anchors):
    """(tx, ty, tw, th) [B, N, 4] against anchors [N, 4] -> xyxy boxes, f32:
    centres shifted by (tx, ty) anchor sizes, sizes scaled by exp(tw, th)."""
    awh = anchors[None, :, 2:4] - anchors[None, :, 0:2]
    actr = anchors[None, :, 0:2] + 0.5 * awh
    wh = torch.exp(reg[..., 2:4].float()) * awh
    ctr = reg[..., 0:2].float() * awh + actr
    return torch.cat([ctr - 0.5 * wh, ctr + 0.5 * wh], dim=-1)
