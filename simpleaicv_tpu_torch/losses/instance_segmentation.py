"""SOLOv2 loss (counterpart of
``simpleaicv_tpu/losses/instance_segmentation.py``), fixed-shape.

Per level, each ground truth whose scale lies in the level's range claims
the grid cells around its mask's centre of mass (the sigma-shrunk box, at
most 3 x 3 cells); where several claim a cell the last one wins. The
category loss is a focal loss over every cell, divided by the claimed
cells. The dice loss runs over a fixed cap of 9 x M (cell, gt) pairs a
level (lossless: no gt claims more than 9 cells), chosen by a stable sort
of the pairs' 0/1 flags (XLA's ``top_k`` order); each pair's mask is its
cell's kernel applied to the mask features (a dynamic 1x1 convolution,
here an einsum).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import LOSSES
from ..models.instance_segmentation.decode import topk_stable
from ..parallel.mesh import global_sum, per_rank

__all__ = ["SOLOV2Loss"]


@LOSSES.register()
class SOLOV2Loss:

    def __init__(self,
                 scale_ranges=((1, 96), (48, 192), (96, 384), (192, 768),
                               (384, 2048)),
                 grid_nums=(40, 36, 24, 16, 12),
                 mask_feature_upsample_scale=4, sigma=0.2, alpha=0.25,
                 gamma=2.0, cls_loss_weight=1.0, dice_loss_weight=3.0,
                 max_pairs_per_level=None):
        self.scale_ranges = scale_ranges
        self.grid_nums = grid_nums
        self.upsample_scale = mask_feature_upsample_scale
        self.sigma = sigma
        self.alpha = alpha
        self.gamma = gamma
        self.cls_loss_weight = cls_loss_weight
        self.dice_loss_weight = dice_loss_weight
        self.max_pairs = max_pairs_per_level

    def __call__(self, preds, gt_bboxes, gt_masks):
        """preds: (mask features [B, h, w, C], kernels per level
        [B, g, g, C], category logits per level [B, g, g, num_classes]);
        gt_bboxes [B, M, 5] pixel xyxy and class (padded with -1); gt_masks
        [B, M, h, w] binary at the mask features' size."""
        mask_feat, kernel_preds, cate_preds = preds
        b = mask_feat.shape[0]
        device = mask_feat.device
        num_classes = cate_preds[0].shape[-1]
        fh, fw = mask_feat.shape[1], mask_feat.shape[2]
        input_h = fh * self.upsample_scale
        input_w = fw * self.upsample_scale

        gt_cls = gt_bboxes[..., 4].float()
        gt_valid = gt_cls >= 0
        boxes = gt_bboxes[..., :4].float()
        wh = boxes[..., 2:4] - boxes[..., 0:2]
        areas = torch.sqrt((wh[..., 0] * wh[..., 1]).clamp(min=0.0))

        m = gt_masks.float()
        mass = m.sum((2, 3))
        m00 = mass.clamp(min=1e-4)
        ys = torch.arange(fh, dtype=torch.float32, device=device)
        xs = torch.arange(fw, dtype=torch.float32, device=device)
        cx = (m * xs).sum((2, 3)) / m00 * self.upsample_scale
        cy = (m * ys[:, None]).sum((2, 3)) / m00 * self.upsample_scale
        mask_nonempty = mass > 0
        half_w = 0.5 * wh[..., 0] * self.sigma
        half_h = 0.5 * wh[..., 1] * self.sigma

        total_cls = torch.zeros((), device=device)
        total_dice = torch.zeros((), device=device)
        total_pos = torch.zeros((), device=device)
        total_pairs = torch.zeros((), device=device)
        mf = mask_feat.float()
        for level, ((lo, hi), g) in enumerate(
                zip(self.scale_ranges, self.grid_nums)):
            hit = gt_valid & (areas >= lo) & (areas <= hi) & mask_nonempty

            def cell_range(center, half, size):
                coord = torch.floor(center / size * g).to(torch.int32)
                low = torch.floor((center - half) / size * g).to(torch.int32)
                high = torch.floor((center + half) / size * g).to(torch.int32)
                low = torch.maximum(low.clamp(min=0), coord - 1)
                high = torch.minimum(high.clamp(max=g - 1), coord + 1)
                return low, high

            left, right = cell_range(cx, half_w, input_w)
            top, down = cell_range(cy, half_h, input_h)
            gi = torch.arange(g, device=device)
            row_in = (gi >= top[..., None]) & (gi <= down[..., None])
            col_in = (gi >= left[..., None]) & (gi <= right[..., None])
            assign = (row_in[..., :, None] & col_in[..., None, :]
                      & hit[..., None, None])                 # [B, M, g, g]

            mm = assign.shape[1]
            gt_rank = torch.arange(1, mm + 1, dtype=torch.float32,
                                   device=device)
            pick = (assign.float() * gt_rank[:, None, None]).argmax(1)
            any_assign = assign.any(1)
            cate_label = torch.where(
                any_assign,
                torch.gather(gt_cls, 1, pick.reshape(b, -1)).reshape(
                    b, g, g) + 1.0, 0.0)

            cate = torch.sigmoid(cate_preds[level].float()).clamp(
                1e-4, 1 - 1e-4)
            one_hot = F.one_hot(cate_label.long(),
                                num_classes + 1)[..., 1:].float()
            alpha_f = torch.where(one_hot == 1.0, self.alpha,
                                  1 - self.alpha)
            pt = torch.where(one_hot == 1.0, cate, 1.0 - cate)
            bce = -(one_hot * torch.log(cate)
                    + (1 - one_hot) * torch.log(1 - cate))
            total_cls = total_cls + (alpha_f * (1 - pt) ** self.gamma
                                     * bce).sum()
            total_pos = total_pos + any_assign.sum()

            flat = assign.reshape(b, mm, g * g).transpose(1, 2).reshape(b, -1)
            cap = self.max_pairs if self.max_pairs else 9 * mm
            k = min(cap, flat.shape[1])
            flags, idx = topk_stable(flat.float(), k)
            cell_idx = idx // mm
            gt_idx = idx % mm
            valid_pair = flags > 0
            rows = torch.arange(b, device=device)[:, None]
            kernels = kernel_preds[level].reshape(b, g * g, -1)
            sel_kernels = kernels[rows, cell_idx].float()      # [B, k, C]
            pred_masks = torch.sigmoid(torch.einsum(
                "bkc,bhwc->bkhw", sel_kernels, mf)).clamp(1e-4, 1 - 1e-4)
            sel_gt = m[rows, gt_idx]                           # [B, k, h, w]
            a = (pred_masks * sel_gt).sum((2, 3))
            bb = (pred_masks * pred_masks).sum((2, 3))
            cc = (sel_gt * sel_gt).sum((2, 3))
            dice = 1.0 - 2.0 * a / (bb + cc + 1e-4)
            total_dice = total_dice + (dice * valid_pair).sum()
            total_pairs = total_pairs + valid_pair.sum()

        total_pos, total_pairs = global_sum(
            torch.stack([total_pos.float(), total_pairs.float()]))
        cls_loss = torch.where(
            total_pos > 0, total_cls / per_rank(total_pos.clamp(min=1.0)),
            0.0)
        dice_loss = torch.where(
            total_pairs > 0,
            total_dice / per_rank(total_pairs.clamp(min=1.0)), 0.0)
        return {"cls_loss": self.cls_loss_weight * cls_loss,
                "dice_loss": self.dice_loss_weight * dice_loss}
