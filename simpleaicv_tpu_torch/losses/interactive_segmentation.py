"""SAM losses (counterpart of
``simpleaicv_tpu/losses/interactive_segmentation.py``): the three multi-level
mask losses (focal + dice + IoU-prediction MSE) and the two distillation
losses. Each is computed in f32 whatever the model's compute dtype; the mask
losses and ``SAMDistillLoss`` return a dict of 0-d tensors under the JAX
package's keys, ``SAMDistillMSELoss`` one 0-d tensor.
"""

from __future__ import annotations

import torch

from ..core.registry import LOSSES
from ..parallel.mesh import global_sum, per_rank

__all__ = ["SAMMultiLevelLoss", "SAMMultiLevelIoUMaxLoss",
           "SAMMultiLevelAssignLoss", "SAMDistillMSELoss", "SAMDistillLoss"]


def _bce_with_logits(logits, t):
    return (logits.clamp(min=0) - logits * t
            + torch.log1p(torch.exp(-logits.abs())))


def _focal(logits, t, alpha, gamma):
    bce = _bce_with_logits(logits, t)
    return alpha * (1.0 - torch.exp(-bce))**gamma * bce


def _flat(pred_masks, targets):
    """(logits [B, K, HW], targets [B, HW]), both f32."""
    b, k = pred_masks.shape[:2]
    return (pred_masks.reshape(b, k, -1).float(),
            targets.reshape(b, -1).float())


def _binary_iou(logits, t, threshold, smooth):
    """IoU of the thresholded logits [..., HW] against t (broadcast), with
    ``smooth`` added above and below; carries no gradient."""
    binary = (logits >= threshold).float()
    inter = (binary * t).sum(dim=-1)
    return (inter + smooth) / (binary.sum(dim=-1) + t.sum(dim=-1) - inter
                               + smooth)


@LOSSES.register()
class SAMMultiLevelLoss:
    """Every mask level contributes: focal and IoU-prediction MSE averaged
    over the batch, dice summed over the whole flattened batch, each then
    averaged over the levels."""

    def __init__(self, alpha=0.8, gamma=2.0, smooth=1e-4,
                 focal_loss_weight=20.0, dice_loss_weight=1.0,
                 iou_predict_loss_weight=1.0, mask_threshold=0.0):
        self.alpha = alpha
        self.gamma = gamma
        self.smooth = smooth
        self.focal_loss_weight = focal_loss_weight
        self.dice_loss_weight = dice_loss_weight
        self.iou_predict_loss_weight = iou_predict_loss_weight
        self.mask_threshold = mask_threshold

    def _weighted(self, focal, dice, iou):
        return {"focal_loss": self.focal_loss_weight * focal,
                "dice_loss": self.dice_loss_weight * dice,
                "iou_predict_loss": self.iou_predict_loss_weight * iou}

    def __call__(self, inputs, targets):
        pred_masks, pred_ious = inputs
        logits, t = _flat(pred_masks, targets)
        b = logits.shape[0]
        tk = t[:, None]
        focal = _focal(logits, tk, self.alpha, self.gamma).mean(dim=(0, 2))
        p = torch.sigmoid(logits)
        dice = 1.0 - (2 * (p * tk).sum(dim=(0, 2)) + self.smooth) / (
            p.sum(dim=(0, 2)) + t.sum() + self.smooth)
        iou_gt = _binary_iou(logits, tk, self.mask_threshold, self.smooth)
        iou_mse = ((pred_ious.float() - iou_gt)**2).sum(dim=0) / b
        return self._weighted(focal.mean(), dice.mean(), iou_mse.mean())


@LOSSES.register()
class SAMMultiLevelIoUMaxLoss(SAMMultiLevelLoss):
    """For every image only the mask level whose binary IoU against the
    ground truth is highest (union + 1e-4) contributes; the single-level
    losses run on those gathered masks."""

    def __call__(self, inputs, targets):
        pred_masks, pred_ious = inputs
        logits, t = _flat(pred_masks, targets)
        b = logits.shape[0]
        binary = (logits >= self.mask_threshold).float()
        inter = (binary * t[:, None]).sum(dim=2)
        union = binary.sum(dim=2) + t.sum(dim=1)[:, None] - inter + 1e-4
        best = (inter / union).argmax(dim=1)
        rows = torch.arange(b, device=logits.device)
        sel = logits[rows, best]                               # [B, HW]
        sel_iou = pred_ious.float()[rows, best]

        focal = _focal(sel, t, self.alpha, self.gamma).mean()
        p = torch.sigmoid(sel)
        dice = 1.0 - (2 * (p * t).sum() + self.smooth) / (
            p.sum() + t.sum() + self.smooth)
        iou_gt = _binary_iou(sel, t, self.mask_threshold, self.smooth)
        iou_mse = ((sel_iou - iou_gt)**2).sum() / b
        return self._weighted(focal, dice, iou_mse)


@LOSSES.register()
class SAMMultiLevelAssignLoss(SAMMultiLevelLoss):
    """Each sample's ground-truth area ratio selects which mask levels train
    (open ranges, several may hit): per-sample mean over its valid levels,
    batch mean over the samples with at least one; dice runs per sample."""

    def __init__(self, alpha=0.8, gamma=2.0, smooth=1e-4,
                 focal_loss_weight=20.0, dice_loss_weight=1.0,
                 iou_predict_loss_weight=1.0, mask_threshold=0.0,
                 idx_nums=4,
                 area_ranges=((0.04, 0.64), (0.0, 0.04), (0.01, 0.25),
                              (0.16, 1.0))):
        super().__init__(alpha, gamma, smooth, focal_loss_weight,
                         dice_loss_weight, iou_predict_loss_weight,
                         mask_threshold)
        if len(area_ranges) != idx_nums:
            raise ValueError(f"{len(area_ranges)} area ranges for "
                             f"{idx_nums} mask levels")
        self.idx_nums = idx_nums
        self.area_ranges = tuple(tuple(r) for r in area_ranges)

    def __call__(self, inputs, targets):
        pred_masks, pred_ious = inputs
        logits, t = _flat(pred_masks, targets)
        if logits.shape[1] != self.idx_nums:
            raise ValueError(f"{logits.shape[1]} mask levels, the loss was "
                             f"built for {self.idx_nums}")
        tk = t[:, None]
        ratio = t.sum(dim=1) / t.shape[1]
        lo = torch.tensor([r[0] for r in self.area_ranges],
                          device=t.device)
        hi = torch.tensor([r[1] for r in self.area_ranges],
                          device=t.device)
        valid = (lo[None] < ratio[:, None]) & (ratio[:, None] < hi[None])
        n_valid = valid.sum(dim=1).float()
        has = n_valid > 0
        n_has = per_rank(global_sum(has.float().sum()).clamp(min=1.0))

        def batch_mean(per_bi):                              # [B, K] -> 0-d
            zero = per_bi.new_zeros(())
            per_sample = (torch.where(valid, per_bi, zero).sum(dim=1)
                          / n_valid.clamp(min=1.0))
            return torch.where(has, per_sample, zero).sum() / n_has

        focal = batch_mean(
            _focal(logits, tk, self.alpha, self.gamma).mean(dim=2))
        p = torch.sigmoid(logits)
        dice = batch_mean(1.0 - (2 * (p * tk).sum(dim=2) + self.smooth) / (
            p.sum(dim=2) + t.sum(dim=1)[:, None] + self.smooth))
        iou_gt = _binary_iou(logits, tk, self.mask_threshold, self.smooth)
        iou = batch_mean((pred_ious.float() - iou_gt)**2)
        return self._weighted(focal, dice, iou)


@LOSSES.register()
class SAMDistillMSELoss:
    """Mean squared difference of the student's and the teacher's encoder
    features."""

    def __call__(self, stu_feature, tea_feature):
        return ((stu_feature.float() - tea_feature.float())**2).mean()


@LOSSES.register()
class SAMDistillLoss:
    """Whole-SAM distillation: the teacher's masks binarised at
    ``mask_threshold``, focal per mask slot and dice over the whole batch on
    the student's logits, MSE on the IoU predictions; each term summed over
    the mask slots and divided by the batch size."""

    def __init__(self, alpha=0.8, gamma=2.0, smooth=1e-4,
                 distill_focal_loss_weight=20.0, distill_dice_loss_weight=1.0,
                 distill_iou_predict_loss_weight=1.0, mask_threshold=0.0):
        self.alpha = alpha
        self.gamma = gamma
        self.smooth = smooth
        self.w_focal = distill_focal_loss_weight
        self.w_dice = distill_dice_loss_weight
        self.w_iou = distill_iou_predict_loss_weight
        self.mask_threshold = mask_threshold

    def __call__(self, tea_inputs, stu_inputs):
        tea_masks, tea_ious = tea_inputs
        stu_masks, stu_ious = stu_inputs
        b, n = stu_masks.shape[:2]
        tea = (tea_masks.float() > self.mask_threshold).float().reshape(
            b, n, -1)
        stu = stu_masks.float().reshape(b, n, -1)
        focal = _focal(stu, tea, self.alpha, self.gamma)
        focal_loss = focal.mean(dim=(0, 2)).sum() / b
        p = torch.sigmoid(stu)
        dice = 1.0 - (2.0 * (p * tea).sum(dim=(0, 2)) + self.smooth) / (
            p.sum(dim=(0, 2)) + tea.sum(dim=(0, 2)) + self.smooth)
        iou_loss = ((stu_ious.float() - tea_ious.float())**2).sum() / b
        return {"distill_focal_loss": self.w_focal * focal_loss,
                "distill_dice_loss": self.w_dice * dice.sum() / b,
                "distill_iou_predict_loss": self.w_iou * iou_loss}
