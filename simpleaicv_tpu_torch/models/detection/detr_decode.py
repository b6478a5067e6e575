"""DETR decoder (counterpart of
``simpleaicv_tpu/models/detection/detr_decode.py``): the last layer's
softmax, the best class and its score, the no-object class and scores at
or below the threshold dropped, the top ``max_object_num`` by score; boxes
are cxcywh scaled by the collater's 'size', in xyxy. No NMS. Fixed shapes,
batched, on the predictions' device."""

from __future__ import annotations

import torch

from ...core.registry import DECODERS
from .decode import pad_detections, top_sorted
from .dinodetr_decode import scaled_xyxy

__all__ = ["DETRDecoder"]


@DECODERS.register()
class DETRDecoder:
    """``decoder(preds, scaled_sizes) -> [scores [B, M], classes [B, M],
    boxes [B, M, 4]]`` as numpy f32, M = ``max_object_num`` (padded when
    there are fewer queries); invalid slots are -1 / -1 / 0. ``preds`` is
    the model's [cls [L, B, Q, C + 1], boxes [L, B, Q, 4]]."""

    takes_sizes = True  # the call takes the collater's 'size'

    def __init__(self, num_classes=80, max_object_num=100,
                 min_score_threshold=0.05, **kwargs):
        self.num_classes = num_classes
        self.max_object_num = max_object_num
        self.min_score_threshold = min_score_threshold

    @torch.no_grad()
    def __call__(self, preds, scaled_sizes):
        scores, classes = torch.softmax(preds[0][-1].float(), -1).max(-1)
        boxes = scaled_xyxy(preds[1][-1], scaled_sizes)
        valid = (classes < self.num_classes) & \
            (scores > self.min_score_threshold)
        masked = torch.where(valid, scores,
                             torch.full_like(scores, -torch.inf))
        top_s, top_i = top_sorted(masked, min(self.max_object_num,
                                              scores.shape[1]))
        ok = top_s > -torch.inf
        out = pad_detections(
            torch.where(ok, top_s, torch.full_like(top_s, -1.0)),
            torch.where(ok, classes.gather(1, top_i).float(),
                        torch.full_like(top_s, -1.0)),
            torch.where(ok[..., None],
                        boxes.gather(1, top_i[..., None].expand(-1, -1, 4)),
                        torch.zeros((), device=boxes.device)),
            self.max_object_num)
        return [t.cpu().numpy() for t in out]
