"""Dense detection losses (counterpart of
``simpleaicv_tpu/losses/detection.py``): ``RetinaLoss`` (IoU anchor
assignment at 0.4 / 0.5, focal classification, SmoothL1 or IoU-type box
loss) and ``FCOSLoss`` (centre-sampled point assignment within each
level's size range, the smallest box winning, focal classification,
centerness-weighted IoU-type box loss and centerness BCE), each term
normalised by the batch's positive count and 0 when it has none.

The assignment is one vectorised, masked computation over the fixed
[B, M, 5] annotation tensor (x1, y1, x2, y2, class; class < 0 pads), on
the annotations' device, without gradients: no per-image loop, no boolean
indexing, no read back to the host. Ties go to the first box, as
``jnp.argmax`` / ``jnp.argmin`` and torch's ``max`` / ``argmin`` give
them. Anchors and points come from the numpy generators once per
(feature sizes, device) (``anchor.OnDevice``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import LOSSES
from ..models.detection.anchor import (FCOSPositions, OnDevice,
                                       RetinaAnchors, anchor_boxes,
                                       feature_sizes, flatten_levels)
from ..ops.iou import iou_method

__all__ = ["RetinaLoss", "FCOSLoss"]

INF = 100000000.0


def _one_hot(gt_cls, num_classes: int):
    """[B, N] classes (id + 1; 0 background, -1 ignored) -> [B, N, C] f32
    one-hot of the ids; background and ignored rows are 0."""
    ids = torch.arange(1, num_classes + 1, device=gt_cls.device,
                       dtype=gt_cls.dtype)
    return (gt_cls[..., None] == ids).float()


def _focal_loss(cls_preds, gt_one_hot, valid_mask, positive_num, alpha,
                gamma):
    """Focal loss of probabilities clamped to [1e-4, 1 - 1e-4], summed over
    the valid anchors and divided by max(positives, 1)."""
    p = cls_preds.float().clamp(1e-4, 1.0 - 1e-4)
    is_one = gt_one_hot == 1.0
    alpha_f = torch.where(is_one, alpha, 1.0 - alpha)
    pt = torch.where(is_one, p, 1.0 - p)
    focal_w = alpha_f * torch.pow(1.0 - pt, gamma)
    bce = -(gt_one_hot * torch.log(p)
            + (1.0 - gt_one_hot) * torch.log(1.0 - p))
    loss = torch.sum(focal_w * bce * valid_mask[:, :, None])
    return loss / positive_num.clamp(min=1.0)


def _zero_without_positives(positive_num, terms: dict) -> dict:
    no_pos = positive_num == 0
    return {k: torch.where(no_pos, torch.zeros_like(v), v)
            for k, v in terms.items()}


@LOSSES.register()
class RetinaLoss:
    """``loss(preds, annotations) -> {"cls_loss", "reg_loss"}``: preds are
    (class probabilities per level [B, h, w, A, C], regressions per level
    [B, h, w, A, 4]); annotations [B, M, 5] in pixels."""

    # an anchor is background below the first IoU, a positive at or above
    # the second, ignored between
    thresholds = (0.4, 0.5)

    def __init__(self,
                 areas=((32, 32), (64, 64), (128, 128), (256, 256),
                        (512, 512)),
                 ratios=(0.5, 1, 2),
                 scales=(2**0, 2**(1.0 / 3.0), 2**(2.0 / 3.0)),
                 strides=(8, 16, 32, 64, 128),
                 alpha=0.25, gamma=2.0, beta=1.0 / 9.0,
                 cls_loss_weight=1.0, box_loss_weight=1.0,
                 box_loss_type="SmoothL1"):
        self._set_anchors(RetinaAnchors(areas, ratios, scales, strides))
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.cls_loss_weight = cls_loss_weight
        self.box_loss_weight = box_loss_weight
        self.box_loss_type = box_loss_type

    def _set_anchors(self, anchors):
        self.anchors = anchors
        self._anchors_on = OnDevice(lambda sizes: (
            anchors.flat_anchors(sizes),))

    def __call__(self, preds, annotations):
        cls_preds, reg_preds = preds
        anchors, = self._anchors_on(feature_sizes(cls_preds),
                                    cls_preds[0].device)
        num_classes = cls_preds[0].shape[-1]
        cls_preds = flatten_levels(cls_preds, num_classes)
        reg_preds = flatten_levels(reg_preds, 4)

        gt_boxes, gt_cls = self.assign(anchors, annotations)
        valid = (gt_cls >= 0).float()
        positive = (gt_cls > 0).float()
        positive_num = positive.sum()

        cls_loss = _focal_loss(cls_preds, _one_hot(gt_cls, num_classes),
                               valid, positive_num, self.alpha, self.gamma)
        if self.box_loss_type == "SmoothL1":
            targets = self._boxes_to_txtytwth(gt_boxes, anchors[None])
            x = torch.abs(reg_preds.float() - targets)
            smooth = torch.where(x >= self.beta, x - 0.5 * self.beta,
                                 0.5 * x * x / self.beta)
            reg_loss = torch.sum(smooth.sum(-1) * positive)
        else:
            pred_boxes = anchor_boxes(reg_preds, anchors)
            ious = iou_method(pred_boxes, gt_boxes,
                              iou_type=self.box_loss_type)
            reg_loss = torch.sum((1.0 - ious) * positive)
        reg_loss = reg_loss / positive_num.clamp(min=1.0)
        terms = _zero_without_positives(positive_num, {
            "cls_loss": cls_loss, "reg_loss": reg_loss})
        return {"cls_loss": self.cls_loss_weight * terms["cls_loss"],
                "reg_loss": self.box_loss_weight * terms["reg_loss"]}

    @torch.no_grad()
    def assign(self, anchors, annotations):
        """anchors [N, 4], annotations [B, M, 5] -> (the best-overlapping
        box of each anchor [B, N, 4] xyxy, its class [B, N]: id + 1, 0
        background, -1 ignored; every anchor of an image without boxes is
        ignored)."""
        annotations = annotations.float()
        gt, cls = annotations[..., :4], annotations[..., 4]
        gt_valid = cls >= 0                                    # [B, M]
        ious = iou_method(anchors[None, :, None, :], gt[:, None, :, :])
        ious = torch.where(gt_valid[:, None, :], ious, -1.0)   # [B, N, M]
        overlap, idx = ious.max(dim=2)
        neg, pos = self.thresholds
        assigned = torch.full_like(overlap, -1.0)
        assigned = torch.where(overlap < neg, 0.0, assigned)
        assigned = torch.where(overlap >= pos, cls.gather(1, idx) + 1.0,
                               assigned)
        assigned = torch.where(gt_valid.any(dim=1, keepdim=True), assigned,
                               -1.0)
        boxes = gt.gather(1, idx[..., None].expand(-1, -1, 4))
        return boxes, assigned

    @staticmethod
    def _boxes_to_txtytwth(gt_boxes, anchors):
        awh = anchors[..., 2:4] - anchors[..., 0:2]
        actr = anchors[..., 0:2] + 0.5 * awh
        gwh = (gt_boxes[..., 2:4] - gt_boxes[..., 0:2]).clamp(min=1e-4)
        gctr = gt_boxes[..., 0:2] + 0.5 * gwh
        return torch.cat([(gctr - actr) / awh, torch.log(gwh / awh)], -1)


@LOSSES.register()
class FCOSLoss:
    """``loss(preds, annotations) -> {"cls_loss", "reg_loss",
    "center_ness_loss"}``: preds are (class probabilities, distances and
    centerness per level); annotations [B, M, 5] in pixels."""

    def __init__(self,
                 strides=(8, 16, 32, 64, 128),
                 mi=((-1, 64), (64, 128), (128, 256), (256, 512),
                     (512, INF)),
                 alpha=0.25, gamma=2.0,
                 cls_loss_weight=1.0, box_loss_weight=1.0,
                 center_ness_loss_weight=1.0, box_loss_iou_type="GIoU",
                 center_sample_radius=1.5, use_center_sample=True):
        self.positions = FCOSPositions(strides)
        self.mi = np.array(mi, np.float32)
        self.alpha = alpha
        self.gamma = gamma
        self.cls_loss_weight = cls_loss_weight
        self.box_loss_weight = box_loss_weight
        self.center_ness_loss_weight = center_ness_loss_weight
        self.box_loss_iou_type = box_loss_iou_type
        self.center_sample_radius = center_sample_radius
        self.use_center_sample = use_center_sample
        self._points_on = OnDevice(self._points)

    def _points(self, sizes):
        """(points [P, 2], their strides [P], their size ranges [P, 2])."""
        pos, strides = self.positions.flat_positions_strides(sizes)
        mi = np.concatenate([
            np.tile(self.mi[i][None], (int(fs[0]) * int(fs[1]), 1))
            for i, fs in enumerate(sizes)])
        return pos, strides, mi

    def __call__(self, preds, annotations):
        cls_preds, reg_preds, center_preds = preds
        points, strides, mi = self._points_on(feature_sizes(cls_preds),
                                              cls_preds[0].device)
        num_classes = cls_preds[0].shape[-1]
        cls_preds = flatten_levels(cls_preds, num_classes)
        reg_preds = flatten_levels(reg_preds, 4)
        center_preds = flatten_levels(center_preds, 1)

        ltrb, gt_cls, centerness = self.assign(points, strides, mi,
                                               annotations)
        positive = (gt_cls > 0).float()
        positive_num = positive.sum()
        cls_loss = _focal_loss(cls_preds, _one_hot(gt_cls, num_classes),
                               torch.ones_like(gt_cls), positive_num,
                               self.alpha, self.gamma)

        exp_reg = torch.exp(reg_preds.float())
        pred_boxes = torch.cat([points[None] - exp_reg[..., 0:2],
                                points[None] + exp_reg[..., 2:4]], -1)
        gt_boxes = torch.cat([points[None] - ltrb[..., 0:2],
                              points[None] + ltrb[..., 2:4]], -1)
        ious = iou_method(pred_boxes, gt_boxes,
                          iou_type=self.box_loss_iou_type)
        reg_loss = torch.sum((1.0 - ious) * centerness * positive)
        reg_loss = reg_loss / positive_num.clamp(min=1.0)

        cp = center_preds[..., 0].float().clamp(1e-4, 1.0 - 1e-4)
        cn_bce = -(centerness * torch.log(cp)
                   + (1.0 - centerness) * torch.log(1.0 - cp))
        center_loss = torch.sum(cn_bce * positive) / positive_num.clamp(
            min=1.0)

        terms = _zero_without_positives(positive_num, {
            "cls_loss": cls_loss, "reg_loss": reg_loss,
            "center_ness_loss": center_loss})
        return {"cls_loss": self.cls_loss_weight * terms["cls_loss"],
                "reg_loss": self.box_loss_weight * terms["reg_loss"],
                "center_ness_loss":
                    self.center_ness_loss_weight * terms["center_ness_loss"]}

    @torch.no_grad()
    def assign(self, points, strides, mi, annotations):
        """points [P, 2], strides [P], size ranges [P, 2], annotations
        [B, M, 5] -> (distances to the chosen box [B, P, 4], its class
        [B, P]: id + 1, 0 background, its centerness [B, P]); a point is
        positive for a box that holds it strictly inside, within
        ``center_sample_radius`` strides of its centre, and whose largest
        distance lies in the point's size range; the smallest such box
        wins."""
        annotations = annotations.float()
        gt, cls = annotations[..., :4], annotations[..., 4]
        gt_valid = cls >= 0                                    # [B, M]
        px = points[None, :, None, 0]
        py = points[None, :, None, 1]
        ltrb = torch.stack([px - gt[:, None, :, 0], py - gt[:, None, :, 1],
                            gt[:, None, :, 2] - px, gt[:, None, :, 3] - py],
                           dim=-1)                             # [B, P, M, 4]
        pos_flag = ltrb.amin(dim=-1) > 0                       # [B, P, M]
        if self.use_center_sample:
            ctr = (gt[:, None, :, 0:2] + gt[:, None, :, 2:4]) / 2
            dist = torch.sqrt((px - ctr[..., 0])**2 + (py - ctr[..., 1])**2)
            pos_flag &= dist < strides[None, :, None] * \
                self.center_sample_radius
        max_ltrb = ltrb.amax(dim=-1)
        pos_flag &= (max_ltrb > mi[None, :, None, 0]) \
            & (max_ltrb < mi[None, :, None, 1]) & gt_valid[:, None, :]

        wh = gt[..., 2:4] - gt[..., 0:2]
        area = wh[..., 0] * wh[..., 1]                         # [B, M]
        choice = torch.where(pos_flag, area[:, None, :], INF).argmin(dim=2)
        has_pos = pos_flag.any(dim=2)                          # [B, P]

        chosen = ltrb.gather(2, choice[:, :, None, None].expand(
            -1, -1, 1, 4))[:, :, 0]                            # [B, P, 4]
        chosen_cls = cls.gather(1, choice) + 1.0
        l_, t_, r_, b_ = chosen.unbind(-1)
        cn = torch.sqrt(((torch.minimum(l_, r_) / torch.maximum(l_, r_))
                         * (torch.minimum(t_, b_) / torch.maximum(t_, b_))
                         ).clamp(min=0.0))
        return (torch.where(has_pos[..., None], chosen, 0.0),
                torch.where(has_pos, chosen_cls, 0.0),
                torch.where(has_pos, cn, 0.0))
