"""IoU and GIoU of xyxy boxes broadcast over any leading dims, in f32
(counterpart of ``simpleaicv_tpu/ops/iou.py::iou_method`` for the types the
ported losses use; DIoU, CIoU, EIoU and xywh boxes wait for a caller)."""

from __future__ import annotations

import torch

__all__ = ["iou_method"]


def iou_method(boxes1, boxes2, iou_type: str = "IoU"):
    if iou_type not in ("IoU", "GIoU"):
        raise ValueError(f"iou_type {iou_type!r} is not ported (IoU, GIoU)")
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    overlap_min = torch.maximum(boxes1[..., 0:2], boxes2[..., 0:2])
    overlap_max = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    overlap_wh = (overlap_max - overlap_min).clamp(min=0.0)
    overlap = overlap_wh[..., 0] * overlap_wh[..., 1]

    wh1 = (boxes1[..., 2:4] - boxes1[..., 0:2]).clamp(min=0.0)
    wh2 = (boxes2[..., 2:4] - boxes2[..., 0:2]).clamp(min=0.0)
    union = (wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1]
             - overlap).clamp(min=1e-4)
    ious = overlap / union
    if iou_type == "IoU":
        return ious

    enc_min = torch.minimum(boxes1[..., 0:2], boxes2[..., 0:2])
    enc_max = torch.maximum(boxes1[..., 2:4], boxes2[..., 2:4])
    enc_wh = (enc_max - enc_min).clamp(min=0.0)
    enc_area = (enc_wh[..., 0] * enc_wh[..., 1]).clamp(min=1e-4)
    return ious - (enc_area - union) / enc_area
