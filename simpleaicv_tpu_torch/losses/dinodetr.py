"""DINO-DETR loss (counterpart of ``simpleaicv_tpu/losses/dinodetr.py``):
Hungarian matching with a focal class cost (weights 2/5/2 on class, L1 and
GIoU) run again for every decoder layer and for the encoder proposals,
sigmoid-focal classification, L1 and GIoU on the matched pairs, and the
denoising queries, whose assignment is known: positives regress and
classify their annotation, negatives are background, padding slots are
not supervised at all."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import LOSSES
from ..ops.iou import iou_method
from .detr import cxcywh_to_xyxy, hungarian_match, pairwise_giou
from ..parallel.mesh import global_sum, per_rank

__all__ = ["DINODETRLoss"]


@LOSSES.register()
class DINODETRLoss:

    def __init__(self, cls_match_cost=2.0, box_match_cost=5.0,
                 giou_match_cost=2.0, cls_loss_weight=1.0,
                 box_l1_loss_weight=5.0, iou_loss_weight=2.0, alpha=0.25,
                 gamma=2.0, num_classes=80, matcher="hungarian"):
        if matcher != "hungarian":
            raise ValueError(f"matcher {matcher!r} is not ported; the port "
                             f"has the host Hungarian matcher")
        self.cls_match_cost = cls_match_cost
        self.box_match_cost = box_match_cost
        self.giou_match_cost = giou_match_cost
        self.cls_loss_weight = cls_loss_weight
        self.box_l1_loss_weight = box_l1_loss_weight
        self.iou_loss_weight = iou_loss_weight
        self.alpha = alpha
        self.gamma = gamma
        self.num_classes = num_classes

    @torch.no_grad()
    def match(self, cls_pred, reg_pred, annotations):
        """[B, Q] matched annotation index per query (-1 unmatched), from the
        focal class cost and the L1 and GIoU box costs; the clamps and
        epsilons are the reference's, so that decisions agree."""
        p = torch.sigmoid(cls_pred.float()).clamp(1e-4, 1.0 - 1e-4)
        reg_pred = reg_pred.float().clamp(1e-4, 1.0 - 1e-4)
        tgt_cls = annotations[..., 4].clamp(min=0).long()
        valid = annotations[..., 4] >= 0
        pos_cost = self.alpha * (1 - p)**self.gamma * -torch.log(p + 1e-4)
        neg_cost = (1 - self.alpha) * p**self.gamma * \
            -torch.log(1 - p + 1e-4)
        idx = tgt_cls[:, None, :].expand(-1, p.shape[1], -1)     # [B, Q, M]
        cls_cost = pos_cost.gather(2, idx) - neg_cost.gather(2, idx)
        l1_cost = (reg_pred[:, :, None, :4]
                   - annotations[:, None, :, :4]).abs().sum(-1)
        giou_cost = -pairwise_giou(cxcywh_to_xyxy(reg_pred[..., :4]),
                                   cxcywh_to_xyxy(annotations[..., :4]))
        cost = (self.cls_match_cost * cls_cost
                + self.box_match_cost * l1_cost
                + self.giou_match_cost * giou_cost)
        cost = torch.where(valid[:, None, :], cost,
                           torch.full_like(cost, 1e8))
        return hungarian_match(cost, valid)

    def losses_for(self, cls_pred, reg_pred, annotations, matched,
                   total_targets, supervise=None):
        """(focal class, L1, GIoU) losses, weighted, given matched indices
        (-1: background). ``supervise`` [B, Q] leaves queries out of the
        class loss altogether (the dn padding slots)."""
        safe = matched.clamp(min=0)
        gt_boxes = annotations[..., :4].gather(
            1, safe[..., None].expand(-1, -1, 4))
        gt_cls = annotations[..., 4].gather(1, safe)
        is_m = (matched >= 0).float()

        p = torch.sigmoid(cls_pred.float()).clamp(1e-4, 1 - 1e-4)
        one_hot = F.one_hot(gt_cls.clamp(min=0).long(),
                            self.num_classes).float() * is_m[..., None]
        positive = one_hot == 1.0
        alpha_f = torch.where(positive, self.alpha, 1 - self.alpha)
        pt = torch.where(positive, p, 1 - p)
        bce = -(one_hot * torch.log(p) + (1 - one_hot) * torch.log(1 - p))
        focal = alpha_f * (1 - pt)**self.gamma * bce
        if supervise is not None:
            focal = focal * supervise.float()[..., None]
        cls_loss = focal.sum() / total_targets

        reg = reg_pred.float().clamp(1e-4, 1 - 1e-4)
        l1_loss = ((reg - gt_boxes).abs().sum(-1) * is_m).sum() \
            / total_targets
        giou = iou_method(cxcywh_to_xyxy(reg), cxcywh_to_xyxy(gt_boxes),
                          iou_type="GIoU")
        giou_loss = ((1 - giou) * is_m).sum() / total_targets
        return (self.cls_loss_weight * cls_loss,
                self.box_l1_loss_weight * l1_loss,
                self.iou_loss_weight * giou_loss)

    def __call__(self, preds, annotations):
        """preds: the DINODETR output dict; annotations [B, M, 5] as
        normalised (cx, cy, w, h, class), class -1 for padding."""
        annotations = annotations.float()
        total_targets = per_rank(global_sum(
            (annotations[..., 4] >= 0).sum().float()).clamp(min=1.0))
        loss_dict = {}
        aux_cls, aux_reg = preds["aux_pred_logits"], preds["aux_pred_boxes"]
        n_layers = aux_cls.shape[0]
        for layer in range(n_layers):
            matched = self.match(aux_cls[layer], aux_reg[layer], annotations)
            terms = self.losses_for(aux_cls[layer], aux_reg[layer],
                                    annotations, matched, total_targets)
            tag = "" if layer == n_layers - 1 else f"layer_{layer}_"
            for name, term in zip(("cls_loss", "box_l1_loss",
                                   "box_iou_loss"), terms):
                loss_dict[f"{tag}{name}"] = term

        if "interm_pred_logits" in preds:
            cls, reg = preds["interm_pred_logits"], preds["interm_pred_boxes"]
            terms = self.losses_for(cls, reg, annotations,
                                    self.match(cls, reg, annotations),
                                    total_targets)
            for name, term in zip(("cls_loss", "box_l1_loss",
                                   "box_iou_loss"), terms):
                loss_dict[f"interm_{name}"] = term

        if preds.get("dn_meta") is not None:
            meta = preds["dn_meta"]
            active = meta["dn_valid"] & meta["dn_is_positive"]
            dn_matched = torch.where(active, meta["dn_gt_index"],
                                     torch.full_like(meta["dn_gt_index"], -1))
            dn_cls, dn_reg = preds["dn_pred_logits"], preds["dn_pred_boxes"]
            dn_total = per_rank(global_sum(
                active.sum().float()).clamp(min=1.0))
            for layer in range(dn_cls.shape[0]):
                terms = self.losses_for(dn_cls[layer], dn_reg[layer],
                                        annotations, dn_matched, dn_total,
                                        supervise=meta["dn_valid"])
                tag = ("dn_" if layer == dn_cls.shape[0] - 1
                       else f"dn_layer_{layer}_")
                for name, term in zip(("cls_loss", "box_l1_loss",
                                       "box_iou_loss"), terms):
                    loss_dict[f"{tag}{name}"] = term
        return loss_dict
