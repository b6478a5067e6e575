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
import torch.nn.functional as F

from ...core.registry import DECODERS
from ...ops.nms import nms_keep_mask

__all__ = ["DINODETRDecoder", "scaled_xyxy", "top_sorted"]


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


def top_sorted(scores, k: int):
    """The ``k`` largest of each row [B, N] by descending score, ties to the
    lower index (``jax.lax.top_k``'s order): (values, indices)."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def pad_detections(scores, classes, boxes, count: int):
    """Pads [B, k] scores and classes with -1 and [B, k, 4] boxes with 0 up
    to ``count`` slots."""
    pad = max(count - scores.shape[1], 0)
    return (F.pad(scores, (0, pad), value=-1.0),
            F.pad(classes, (0, pad), value=-1.0),
            F.pad(boxes, (0, 0, 0, pad)))


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

        inf = torch.full_like(scores, -torch.inf)
        masked = torch.where(scores > self.min_score_threshold, scores, inf)
        top_s, top_i = top_sorted(masked, min(self.topn, scores.shape[1]))
        top_valid = top_s > -torch.inf
        top_b = boxes.gather(1, top_i[..., None].expand(-1, -1, 4))
        top_c = classes.gather(1, top_i)
        keep = top_valid
        if self.nms_type:
            nms_boxes = torch.where(top_valid[..., None], top_b,
                                    torch.full_like(top_b, -1e8))
            keep = nms_keep_mask(
                nms_boxes, torch.where(top_valid, top_s,
                                       torch.full_like(top_s, -1e9)),
                self.nms_threshold, self.nms_type) & top_valid
        final = torch.where(keep, top_s, torch.full_like(top_s, -torch.inf))
        out_s, out_i = top_sorted(final, min(self.max_object_num,
                                             final.shape[1]))
        ok = out_s > -torch.inf
        out = pad_detections(
            torch.where(ok, out_s, torch.full_like(out_s, -1.0)),
            torch.where(ok, top_c.gather(1, out_i).float(),
                        torch.full_like(out_s, -1.0)),
            torch.where(ok[..., None],
                        top_b.gather(1, out_i[..., None].expand(-1, -1, 4)),
                        torch.zeros((), device=top_b.device)),
            self.max_object_num)
        return [t.cpu().numpy() for t in out]
