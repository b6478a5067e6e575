"""DINO-DETR decoder (counterpart of
``simpleaicv_tpu/models/detection/dinodetr_decode.py``): per query the
sigmoid's best class and its score, the score threshold, the top ``topn``
by score, class-agnostic NMS, then the top ``max_object_num``; boxes are
cxcywh scaled by the collater's 'size' (the resized height and width), in
xyxy. Fixed shapes, batched, on the predictions' device; the NMS sweep
reads one boolean matrix on the host (``ops/nms.py``).

Against the JAX package: where fewer than ``max_object_num`` candidates
survive the top ``topn`` (fewer queries than that), the output is padded
with invalid slots, as ``DETRDecoder`` pads; the JAX decoder raises there.
"""

from __future__ import annotations

import torch

from ...core.registry import DECODERS
from .decode import decode_batch

__all__ = ["DINODETRDecoder", "scaled_xyxy"]


def scaled_xyxy(boxes, sizes):
    """cxcywh in [0, 1] [B, Q, 4] and sizes [B, 2] as (h, w) -> xyxy in
    pixels, f32."""
    boxes = boxes.float()
    xyxy = torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                      boxes[..., :2] + boxes[..., 2:] / 2], -1)
    sizes = torch.as_tensor(sizes, dtype=torch.float32, device=boxes.device)
    scale = torch.stack([sizes[:, 1], sizes[:, 0], sizes[:, 1],
                         sizes[:, 0]], -1)[:, None, :]
    return xyxy * scale


@DECODERS.register()
class DINODETRDecoder:
    """``decoder(preds, scaled_sizes) -> [scores [B, M], classes [B, M],
    boxes [B, M, 4]]`` as numpy f32, M = ``max_object_num``; invalid slots
    are -1 / -1 / 0. ``preds`` holds the model's ``pred_logits`` [B, Q, C]
    and ``pred_boxes`` [B, Q, 4]."""

    takes_sizes = True  # the call takes the collater's 'size'

    def __init__(self, num_classes=80, max_object_num=100,
                 min_score_threshold=0.05, topn=300,
                 nms_type="python_nms", nms_threshold=0.5, **kwargs):
        self.num_classes = num_classes
        self.max_object_num = max_object_num
        self.min_score_threshold = min_score_threshold
        self.topn = topn
        self.nms_type = ("python_nms" if nms_type == "torch_nms"
                         else nms_type)
        self.nms_threshold = nms_threshold

    @torch.no_grad()
    def __call__(self, preds, scaled_sizes):
        probs = torch.sigmoid(preds["pred_logits"].float())
        scores, classes = probs.max(-1)
        boxes = scaled_xyxy(preds["pred_boxes"], scaled_sizes)
        return decode_batch(scores, classes, boxes, self.max_object_num,
                            self.min_score_threshold, self.topn,
                            self.nms_type, self.nms_threshold)
