"""DETR-family loss helpers (counterpart of the helpers of
``simpleaicv_tpu/losses/detr.py``): box conversion, pairwise GIoU and the
Hungarian matcher, which runs scipy's ``linear_sum_assignment`` on the host.
``DETRLoss`` itself is not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.iou import iou_method

__all__ = ["cxcywh_to_xyxy", "pairwise_giou", "hungarian_match"]


def cxcywh_to_xyxy(b):
    return torch.cat([b[..., :2] - b[..., 2:] / 2,
                      b[..., :2] + b[..., 2:] / 2], -1)


def pairwise_giou(a, b):
    """a [..., Q, 4], b [..., M, 4] xyxy -> [..., Q, M] GIoU."""
    return iou_method(a[..., :, None, :], b[..., None, :, :], iou_type="GIoU")


def hungarian_match(cost, valid_m):
    """cost [B, Q, M]; valid_m [B, M] bool -> the matched annotation index
    of every query [B, Q] (-1 unmatched), on cost's device. The cost matrix
    is copied to the host, where scipy assigns each valid annotation one
    query; non-finite costs are clamped to +-1e8 (NaN to 0) first."""
    from scipy.optimize import linear_sum_assignment
    cost_np = cost.detach().float().cpu().numpy()
    valid_np = valid_m.cpu().numpy()
    b, q, _ = cost_np.shape
    out = np.full((b, q), -1, np.int64)
    for i in range(b):
        mv = valid_np[i]
        if not mv.any():
            continue
        sub = np.nan_to_num(cost_np[i][:, mv], posinf=1e8, neginf=-1e8)
        rows, cols = linear_sum_assignment(sub)
        out[i, rows] = np.nonzero(mv)[0][cols]
    return torch.from_numpy(out).to(cost.device)
