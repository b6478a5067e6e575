"""IoU, GIoU, DIoU, CIoU and EIoU of boxes broadcast over any leading
dims, in f32 (counterpart of ``simpleaicv_tpu/ops/iou.py::iou_method``).
Boxes are xyxy, or (cx, cy, w, h) with ``box_type="xywh"``. Every
denominator is clipped at 1e-4, so degenerate boxes (zero width, identical
boxes) give finite values; CIoU's trade-off weight ``alpha`` carries no
gradient."""

from __future__ import annotations

import math

import torch

__all__ = ["iou_method"]

IOU_TYPES = ("IoU", "GIoU", "DIoU", "CIoU", "EIoU")


def _xywh_to_xyxy(boxes):
    return torch.cat([boxes[..., :2] - boxes[..., 2:4] / 2,
                      boxes[..., :2] + boxes[..., 2:4] / 2], -1)


def iou_method(boxes1, boxes2, iou_type: str = "IoU",
               box_type: str = "xyxy"):
    if iou_type not in IOU_TYPES:
        raise ValueError(f"unknown iou_type {iou_type!r}: {IOU_TYPES}")
    if box_type not in ("xyxy", "xywh"):
        raise ValueError(f"unknown box_type {box_type!r}: xyxy, xywh")
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    if box_type == "xywh":
        boxes1, boxes2 = _xywh_to_xyxy(boxes1), _xywh_to_xyxy(boxes2)

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
    if iou_type == "GIoU":
        enc_area = (enc_wh[..., 0] * enc_wh[..., 1]).clamp(min=1e-4)
        return ious - (enc_area - union) / enc_area

    c2 = (enc_wh[..., 0]**2 + enc_wh[..., 1]**2).clamp(min=1e-4)
    ctr1 = (boxes1[..., 2:4] + boxes1[..., 0:2]) / 2
    ctr2 = (boxes2[..., 2:4] + boxes2[..., 0:2]) / 2
    p2 = (ctr1[..., 0] - ctr2[..., 0])**2 + (ctr1[..., 1] - ctr2[..., 1])**2
    if iou_type == "DIoU":
        return ious - p2 / c2
    if iou_type == "CIoU":
        v = (4.0 / math.pi**2) * (
            torch.atan(wh2[..., 0] / wh2[..., 1].clamp(min=1e-4))
            - torch.atan(wh1[..., 0] / wh1[..., 1].clamp(min=1e-4)))**2
        with torch.no_grad():
            alpha = v / (1.0 - ious + v).clamp(min=1e-4)
        return ious - (p2 / c2 + v * alpha)
    pw2 = (wh2[..., 0] - wh1[..., 0])**2
    ph2 = (wh2[..., 1] - wh1[..., 1])**2
    cw2 = (enc_wh[..., 0]**2).clamp(min=1e-4)
    ch2 = (enc_wh[..., 1]**2).clamp(min=1e-4)
    return ious - (p2 / c2 + pw2 / cw2 + ph2 / ch2)
