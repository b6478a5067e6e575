"""DETR loss (counterpart of ``simpleaicv_tpu/losses/detr.py``) and the
DETR family's helpers: box conversion, pairwise GIoU and the Hungarian
matcher, which runs scipy's ``linear_sum_assignment`` on the host.

``DETRLoss``: the last decoder layer's predictions are matched to the
annotations (costs 1 / 5 / 2 on the class probability, L1 and GIoU), and
every layer is held to that one matching by cross entropy (the no-object
class weighted 0.1), L1 and GIoU on the matched pairs. The JAX package's
alternative auction matcher (``ops/matcher.py``) is not ported."""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import LOSSES
from ..ops.iou import iou_method
from ..parallel.mesh import global_sum, per_rank

__all__ = ["cxcywh_to_xyxy", "pairwise_giou", "hungarian_match", "DETRLoss"]


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


@LOSSES.register()
class DETRLoss:

    def __init__(self, cls_match_cost=1.0, box_match_cost=5.0,
                 giou_match_cost=2.0, cls_loss_weight=1.0,
                 box_l1_loss_weight=5.0, iou_loss_weight=2.0,
                 no_object_cls_weight=0.1, num_classes=80,
                 matcher="hungarian"):
        if matcher != "hungarian":
            raise ValueError(f"matcher {matcher!r} is not ported; the port "
                             f"has the host Hungarian matcher")
        self.cls_match_cost = cls_match_cost
        self.box_match_cost = box_match_cost
        self.giou_match_cost = giou_match_cost
        self.cls_loss_weight = cls_loss_weight
        self.box_l1_loss_weight = box_l1_loss_weight
        self.iou_loss_weight = iou_loss_weight
        self.no_object_cls_weight = no_object_cls_weight
        self.num_classes = num_classes

    @torch.no_grad()
    def match(self, cls_pred, reg_pred, annotations):
        """[B, Q] matched annotation index per query (-1 unmatched), from
        the last layer's class probabilities and boxes."""
        probs = torch.softmax(cls_pred.float(), -1)
        tgt_cls = annotations[..., 4].clamp(min=0).long()
        valid = annotations[..., 4] >= 0
        cls_cost = -probs.gather(
            2, tgt_cls[:, None, :].expand(-1, probs.shape[1], -1))
        l1_cost = (reg_pred[:, :, None, :4].float()
                   - annotations[:, None, :, :4]).abs().sum(-1)
        giou_cost = -pairwise_giou(cxcywh_to_xyxy(reg_pred[..., :4].float()),
                                   cxcywh_to_xyxy(annotations[..., :4]))
        cost = (self.cls_match_cost * cls_cost
                + self.box_match_cost * l1_cost
                + self.giou_match_cost * giou_cost)
        cost = torch.where(valid[:, None, :], cost,
                           torch.full_like(cost, 1e8))
        return hungarian_match(cost, valid)

    def __call__(self, preds, annotations):
        """preds: [cls [L, B, Q, C + 1], boxes [L, B, Q, 4]]; annotations
        [B, M, 5] as normalised (cx, cy, w, h, class), class -1 for
        padding. Returns the weighted class, L1 and GIoU terms of every
        layer, ``layer_{l}_cls_loss`` and so on."""
        cls_preds, reg_preds = preds
        reg_preds = reg_preds.clamp(1e-4, 1.0 - 1e-4)
        annotations = annotations.float()
        matched = self.match(cls_preds[-1], reg_preds[-1], annotations)

        total_targets = per_rank(global_sum(
            (annotations[..., 4] >= 0).sum().float()).clamp(min=1.0))
        safe_idx = matched.clamp(min=0)
        gt_boxes = annotations[..., :4].gather(
            1, safe_idx[..., None].expand(-1, -1, 4))
        gt_cls = annotations[..., 4].gather(1, safe_idx)
        is_matched = (matched >= 0).float()
        target_classes = torch.where(
            matched >= 0, gt_cls,
            torch.full_like(gt_cls, float(self.num_classes))).long()
        class_weights = torch.ones(self.num_classes + 1,
                                   device=annotations.device)
        class_weights[-1] = self.no_object_cls_weight
        w = class_weights[target_classes]
        w_total = per_rank(global_sum(w.sum()).clamp(min=1e-8))

        loss_dict = {}
        for layer in range(cls_preds.shape[0]):
            logp = torch.log_softmax(cls_preds[layer].float(), -1)
            nll = -logp.gather(-1, target_classes[..., None])[..., 0]
            cls_loss = (nll * w).sum() / w_total
            reg = reg_preds[layer].float()
            l1 = (reg - gt_boxes).abs().sum(-1)
            l1_loss = (l1 * is_matched).sum() / total_targets
            giou = iou_method(cxcywh_to_xyxy(reg), cxcywh_to_xyxy(gt_boxes),
                              iou_type="GIoU")
            giou_loss = ((1.0 - giou) * is_matched).sum() / total_targets
            loss_dict[f"layer_{layer}_cls_loss"] = \
                self.cls_loss_weight * cls_loss
            loss_dict[f"layer_{layer}_box_l1_loss"] = \
                self.box_l1_loss_weight * l1_loss
            loss_dict[f"layer_{layer}_box_iou_loss"] = \
                self.iou_loss_weight * giou_loss
        return loss_dict
