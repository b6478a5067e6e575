"""YOLACT loss (counterpart of ``simpleaicv_tpu/losses/yolact.py``),
fixed-shape over the batch.

SSD matching (background below IoU 0.4, ignored from 0.4 to 0.5, each
ground truth forced onto its best anchor); softmax cross-entropy over the
positives and the hard negatives (3 per positive, ranked by logsumexp minus
the background logit with a stable sort, as JAX's ``argsort``); smooth-L1
box offsets with variances (0.1, 0.2); the prototype-mask BCE of the first
``choose_max_mask_num`` positives in anchor order (a stable sort of the 0/1
flags, XLA's ``top_k`` order), each cropped to its padded box and divided
by its box's area; the per-class semantic BCE against the masks 2 x 2
max-pooled to the semantic grid.

Where several ground truths force the same anchor, the last one in slot
order wins, as XLA's sequential scatter on the CPU gives it.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from ..core.registry import LOSSES
from ..models.instance_segmentation.decode import topk_stable
from ..models.instance_segmentation.yolact import YOLACTAnchors
from ..parallel.mesh import global_sum, per_rank

__all__ = ["YOLACTLoss"]


@LOSSES.register()
class YOLACTLoss:

    def __init__(self, resize=544, resize_type="yolo_style",
                 scales=(24, 48, 96, 192, 384), ratios=(1, 0.5, 2),
                 strides=(8, 16, 32, 64, 128), cls_loss_weight=1.0,
                 box_loss_weight=1.5, mask_loss_weight=6.125,
                 semantic_seg_loss_weight=1.0, choose_max_mask_num=100):
        if resize_type == "retina_style":
            resize = int(round(resize * 1333.0 / 800))
        self.resize = resize
        self.anchors = YOLACTAnchors(resize=resize, scales=scales,
                                     ratios=ratios, strides=strides)
        self.cls_loss_weight = cls_loss_weight
        self.box_loss_weight = box_loss_weight
        self.mask_loss_weight = mask_loss_weight
        self.semantic_seg_loss_weight = semantic_seg_loss_weight
        self.max_masks = choose_max_mask_num

    @lru_cache(maxsize=8)
    def _anchors_on(self, sizes, device):
        with torch.inference_mode(False):
            return torch.from_numpy(self.anchors.flat_anchors(sizes)).to(
                device)

    def __call__(self, preds, gt_bboxes, gt_masks):
        """gt_bboxes [B, M, 5] relative xyxy and class (padded with -1);
        gt_masks [B, M, hp, wp] binary at the prototypes' size."""
        class_preds, box_preds, coef_preds, proto_outs, seg_preds = preds
        sizes = tuple((p.shape[2], p.shape[1]) for p in class_preds)
        anchors = self._anchors_on(sizes, proto_outs.device)
        b = proto_outs.shape[0]
        nc = class_preds[0].shape[-1]
        cp = torch.cat([p.reshape(b, -1, nc) for p in class_preds], 1)
        bp = torch.cat([p.reshape(b, -1, 4) for p in box_preds], 1)
        kp = torch.cat([p.reshape(b, -1, p.shape[-1]) for p in coef_preds], 1)

        cls_labels, box_labels, max_gt_boxes, max_gt_idx = self._assign(
            anchors, gt_bboxes.float())
        cls_loss = self._cls_loss(cp, cls_labels)
        box_loss = self._box_loss(bp, box_labels, cls_labels)
        mask_loss = self._mask_loss(kp, proto_outs, gt_masks, max_gt_boxes,
                                    max_gt_idx, cls_labels)
        seg_loss = self._semantic_seg_loss(seg_preds, gt_masks, gt_bboxes)
        return {"cls_loss": self.cls_loss_weight * cls_loss,
                "box_loss": self.box_loss_weight * box_loss,
                "mask_loss": self.mask_loss_weight * mask_loss,
                "segmantic_seg_loss":
                    self.semantic_seg_loss_weight * seg_loss}

    # ---- assignment ----
    @staticmethod
    def _assign(anchors, ann):
        """ann [B, M, 5] -> (class labels [B, A] (-1 ignored, 0
        background), box targets [B, A, 4], matched boxes [B, A, 4],
        matched ground truth [B, A])."""
        gt, cls = ann[..., :4], ann[..., 4]
        b, m = cls.shape
        gt_valid = cls >= 0
        dec = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                         anchors[:, :2] + anchors[:, 2:] / 2], 1)
        lt = torch.maximum(gt[:, :, None, :2], dec[None, None, :, :2])
        rb = torch.minimum(gt[:, :, None, 2:], dec[None, None, :, 2:])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        area_g = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
        area_a = (dec[:, 2] - dec[:, 0]) * (dec[:, 3] - dec[:, 1])
        iou = inter / (area_g[..., None] + area_a - inter).clamp(min=1e-8)
        iou = torch.where(gt_valid[..., None], iou, -1.0)     # [B, M, A]
        del lt, rb, wh, inter

        gt_best_anchor = iou.argmax(2)                        # [B, M]
        anchor_iou = iou.amax(1)                              # [B, A]
        anchor_gt = iou.argmax(1)                             # [B, A]
        force = torch.zeros_like(anchor_iou).scatter_add_(
            1, gt_best_anchor, torch.where(gt_valid, 2.0, 0.0))
        anchor_iou = torch.where(force > 0, 2.0, anchor_iou)
        slots = torch.arange(m, device=ann.device).expand(b, m)
        writer = torch.full_like(anchor_gt, -1).scatter_reduce_(
            1, gt_best_anchor, slots, "amax")
        writer_valid = torch.gather(gt_valid, 1, writer.clamp(min=0))
        forced_idx = torch.where((writer >= 0) & writer_valid, writer, -1)
        anchor_gt = torch.where(forced_idx >= 0, forced_idx, anchor_gt)

        cls_label = torch.gather(cls, 1, anchor_gt) + 1.0
        cls_label = torch.where(anchor_iou < 0.5, -1.0, cls_label)
        cls_label = torch.where(anchor_iou < 0.4, 0.0, cls_label)
        cls_label = torch.where(gt_valid.any(1, keepdim=True), cls_label, 0.0)

        matched = torch.gather(gt, 1, anchor_gt[..., None].expand(-1, -1, 4))
        g_cxcy = ((matched[..., :2] + matched[..., 2:]) / 2
                  - anchors[:, :2]) / (0.1 * anchors[:, 2:])
        g_wh = torch.log(((matched[..., 2:] - matched[..., :2])
                          / anchors[:, 2:]).clamp(min=1e-8)) / 0.2
        return cls_label, torch.cat([g_cxcy, g_wh], -1), matched, anchor_gt

    # ---- losses ----
    @staticmethod
    def _cls_loss(class_preds, cls_labels, neg_ratio=3.0):
        b, a, _ = class_preds.shape
        logits = class_preds.float()
        pos = cls_labels > 0
        n_pos = pos.sum()
        with torch.no_grad():
            mark = torch.logsumexp(logits, -1) - logits[..., 0]
            mark = torch.where(pos | (cls_labels < 0), -torch.inf, mark)
            order = torch.argsort(-mark, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(a, device=order.device).expand(b, a))
            n_neg = torch.minimum(
                neg_ratio * pos.sum(1, keepdim=True),
                torch.isfinite(mark).sum(1, keepdim=True).float())
            neg = (rank < n_neg) & ~pos & (cls_labels >= 0)
        labels = cls_labels.clamp(min=0).long()
        logp = torch.log_softmax(logits, -1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = (ce * (pos | neg)).sum()
        n_pos = global_sum(n_pos)
        return torch.where(n_pos > 0, loss / per_rank(n_pos.clamp(min=1)),
                           0.0)

    @staticmethod
    def _box_loss(box_preds, box_labels, cls_labels, beta=1.0):
        pos = (cls_labels > 0).float()
        n_pos = global_sum(pos.sum())
        x = (box_preds.float() - box_labels).abs()
        sl1 = torch.where(x >= beta, x - 0.5 * beta, 0.5 * x * x / beta)
        loss = (sl1.sum(-1) * pos).sum()
        return torch.where(n_pos > 0, loss / per_rank(n_pos.clamp(min=1.0)),
                           0.0)

    def _mask_loss(self, coef_preds, proto_outs, gt_masks, max_gt_boxes,
                   max_gt_idx, cls_labels):
        b, hp, wp, _ = proto_outs.shape
        device = proto_outs.device
        pos = cls_labels > 0
        n_pos_total = global_sum(pos.sum())
        sel_flag, sel = topk_stable(pos.float(), self.max_masks)  # [B, k]
        valid = sel_flag > 0
        rows = torch.arange(b, device=device)[:, None]
        c = coef_preds[rows, sel]                                # [B, k, P]
        gbox = max_gt_boxes[rows, sel]                           # [B, k, 4]
        gmask = gt_masks[rows, max_gt_idx[rows, sel]].float()  # [B, k, h, w]
        pred = torch.sigmoid(torch.einsum(
            "bkp,bhwp->bkhw", c.float(), proto_outs.float())).clamp(
            1e-4, 1 - 1e-4)
        x1 = (torch.minimum(gbox[..., 0], gbox[..., 2]) * wp - 1).clamp(min=0)
        x2 = (torch.maximum(gbox[..., 0], gbox[..., 2]) * wp + 1).clamp(
            max=wp)
        y1 = (torch.minimum(gbox[..., 1], gbox[..., 3]) * hp - 1).clamp(min=0)
        y2 = (torch.maximum(gbox[..., 1], gbox[..., 3]) * hp + 1).clamp(
            max=hp)
        cols = torch.arange(wp, dtype=torch.float32, device=device)
        rws = torch.arange(hp, dtype=torch.float32, device=device)[:, None]
        crop = ((cols >= x1[..., None, None]) & (cols < x2[..., None, None])
                & (rws >= y1[..., None, None]) & (rws < y2[..., None, None]))
        pred = torch.where(crop, pred, 1e-4)
        bce = -(gmask * torch.log(pred) + (1 - gmask) * torch.log(1 - pred))
        area = ((gbox[..., 2] - gbox[..., 0])
                * (gbox[..., 3] - gbox[..., 1])).clamp(min=1e-8)
        total = (bce.sum((2, 3)) / area * valid).sum()
        denom = hp * wp * per_rank(n_pos_total.clamp(min=1))
        return torch.where(n_pos_total > 0, total / denom, 0.0)

    @staticmethod
    def _semantic_seg_loss(seg_preds, gt_masks, gt_bboxes):
        b, sh, sw, nc = seg_preds.shape
        masks = gt_masks.float()
        mm, hp, wp = masks.shape[1:]
        fy, fx = hp // sh, wp // sw
        if fy > 1 or fx > 1:
            masks = masks.reshape(b, mm, sh, fy, sw, fx).amax((3, 5))
        cls = gt_bboxes[..., 4]
        valid = (cls >= 0).float()
        one_hot = F.one_hot(cls.clamp(0, nc - 1).long(), nc).float() \
            * valid[..., None]                                 # [B, M, nc]
        # the largest of 0/1 products over the instances: their count,
        # capped at 1
        target = torch.einsum("bmhw,bmc->bhwc", masks, one_hot).clamp(
            max=1.0)
        p = torch.sigmoid(seg_preds.float()).clamp(1e-4, 1 - 1e-4)
        bce = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
        return bce.sum() / (sh * sw * b)
