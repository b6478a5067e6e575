"""Dense detection decoders (counterpart of
``simpleaicv_tpu/models/detection/decode.py``) and the batched decode they
share with the DETR-family decoders.

``decode_batch``: the scores above ``min_score_threshold``, the top
``topn`` by score, class-agnostic greedy NMS (``ops/nms.py``), then the top
``max_object_num``, padded with invalid slots (-1 score, -1 class, 0 box)
where fewer survive. Fixed shapes, batched, on the predictions' device;
the NMS sweep reads one boolean matrix on the host. Ties keep the lower
index first (``jax.lax.top_k``'s order), by stable sorts.

``RetinaDecoder`` decodes (tx, ty, tw, th) against the anchors and
``FCOSDecoder`` the exp-distances from the points (its score
sqrt(class probability x centerness)); both truncate the boxes toward 0,
as the reference's int cast does. Against the JAX package: where fewer
than ``max_object_num`` candidates survive ``topn``, the output is padded,
where the JAX decoders raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.registry import DECODERS
from ...ops.nms import nms_keep_mask
from .anchor import (FCOSPositions, OnDevice, RetinaAnchors, anchor_boxes,
                     feature_sizes, flatten_levels)

__all__ = ["RetinaDecoder", "FCOSDecoder", "decode_batch", "top_sorted",
           "pad_detections"]


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


@torch.no_grad()
def decode_batch(scores, classes, boxes, max_object_num: int,
                 min_score_threshold: float, topn: int, nms_type,
                 nms_threshold: float):
    """scores [B, N], classes [B, N], boxes [B, N, 4] xyxy -> [scores
    [B, M], classes [B, M], boxes [B, M, 4]] as numpy f32, M =
    ``max_object_num``; no NMS when ``nms_type`` is empty."""
    masked = torch.where(scores > min_score_threshold, scores, -torch.inf)
    top_s, top_i = top_sorted(masked, min(topn, scores.shape[1]))
    top_valid = top_s > -torch.inf
    top_b = boxes.gather(1, top_i[..., None].expand(-1, -1, 4))
    top_c = classes.gather(1, top_i)
    keep = top_valid
    if nms_type:
        # invalid candidates far away, so that they suppress nobody
        nms_boxes = torch.where(top_valid[..., None], top_b, -1e8)
        keep = nms_keep_mask(nms_boxes, torch.where(top_valid, top_s, -1e9),
                             nms_threshold, nms_type) & top_valid
    final = torch.where(keep, top_s, -torch.inf)
    out_s, out_i = top_sorted(final, min(max_object_num, final.shape[1]))
    ok = out_s > -torch.inf
    out = pad_detections(
        torch.where(ok, out_s, -1.0),
        torch.where(ok, top_c.gather(1, out_i).float(), -1.0),
        torch.where(ok[..., None],
                    top_b.gather(1, out_i[..., None].expand(-1, -1, 4)), 0.0),
        max_object_num)
    return [t.cpu().numpy() for t in out]


class _DecoderBase:
    """``decoder(preds) -> [scores [B, M], classes [B, M], boxes [B, M, 4]]``
    as numpy f32, boxes in the network input's pixels."""

    def __init__(self, max_object_num=100, min_score_threshold=0.05,
                 topn=1000, nms_type="python_nms", nms_threshold=0.5):
        if nms_type not in ("torch_nms", "python_nms", "diou_python_nms"):
            raise ValueError(f"unknown nms_type {nms_type!r}")
        self.max_object_num = max_object_num
        self.min_score_threshold = min_score_threshold
        self.topn = topn
        self.nms_type = "python_nms" if nms_type == "torch_nms" else nms_type
        self.nms_threshold = nms_threshold

    def _decode(self, scores, classes, boxes):
        return decode_batch(scores, classes, boxes, self.max_object_num,
                            self.min_score_threshold, self.topn,
                            self.nms_type, self.nms_threshold)


@DECODERS.register()
class RetinaDecoder(_DecoderBase):

    def __init__(self,
                 areas=((32, 32), (64, 64), (128, 128), (256, 256),
                        (512, 512)),
                 ratios=(0.5, 1, 2),
                 scales=(2**0, 2**(1.0 / 3.0), 2**(2.0 / 3.0)),
                 strides=(8, 16, 32, 64, 128), **kwargs):
        super().__init__(**kwargs)
        self.anchors = RetinaAnchors(areas, ratios, scales, strides)
        self._anchors_on = OnDevice(lambda sizes: (
            self.anchors.flat_anchors(sizes),))

    @torch.no_grad()
    def __call__(self, preds):
        cls_preds, reg_preds = preds
        anchors, = self._anchors_on(feature_sizes(cls_preds),
                                    cls_preds[0].device)
        cls_preds = flatten_levels(cls_preds, cls_preds[0].shape[-1])
        scores, classes = cls_preds.float().max(dim=2)
        boxes = torch.trunc(anchor_boxes(flatten_levels(reg_preds, 4),
                                         anchors))
        return self._decode(scores, classes, boxes)


@DECODERS.register()
class FCOSDecoder(_DecoderBase):

    def __init__(self, strides=(8, 16, 32, 64, 128), **kwargs):
        kwargs.setdefault("nms_threshold", 0.6)
        super().__init__(**kwargs)
        self.positions = FCOSPositions(strides)
        self._points_on = OnDevice(lambda sizes: (
            self.positions.flat_positions_strides(sizes)[0],))

    @torch.no_grad()
    def __call__(self, preds):
        cls_preds, reg_preds, center_preds = preds
        points, = self._points_on(feature_sizes(cls_preds),
                                  cls_preds[0].device)
        cls_preds = flatten_levels(cls_preds, cls_preds[0].shape[-1])
        scores, classes = cls_preds.float().max(dim=2)
        centerness = flatten_levels(center_preds, 1)[..., 0].float()
        scores = torch.sqrt(scores * centerness)
        exp_reg = torch.exp(flatten_levels(reg_preds, 4).float())
        boxes = torch.trunc(torch.cat([points[None] - exp_reg[..., 0:2],
                                       points[None] + exp_reg[..., 2:4]], 2))
        return self._decode(scores, classes, boxes)
