"""DBNet's loss (counterpart of ``simpleaicv_tpu/losses/text_detection.py``):
the probability map's BCE with online hard negative mining (at most three
negatives a positive), the threshold map's L1 inside its band and the dice
loss of the differentiable binarisation 1 / (1 + exp(-k (p - t))), all in
f32.

The mining keeps the JAX form: one descending sort of the flattened
negative losses and a rank mask against the negative count, which stays a
tensor on the device (no ``.item()``, no ``topk`` of a data-dependent
size). Ties in the sort do not change the sum.
"""

from __future__ import annotations

import torch

from ..core.registry import LOSSES
from ..parallel.mesh import global_sum, per_rank

__all__ = ["DBNetLoss"]


@LOSSES.register()
class DBNetLoss:

    def __init__(self, probability_weight=1.0, threshold_weight=5.0,
                 binary_weight=1.0, negative_ratio=3.0, k=50.0):
        self.probability_weight = probability_weight
        self.threshold_weight = threshold_weight
        self.binary_weight = binary_weight
        self.negative_ratio = negative_ratio
        self.k = k

    def __call__(self, preds, shapes):
        """preds [B, H, W, 2] (probability, threshold); ``shapes`` holds the
        map generator's four [B, H, W] maps. Returns the three weighted
        terms."""
        prob = preds[..., 0].float()
        thresh = preds[..., 1].float()
        binary = 1.0 / (1.0 + torch.exp(-self.k * (prob - thresh)))
        prob = torch.clamp(prob, 1e-4, 1.0 - 1e-4)

        p_mask = shapes["probability_mask"].float()
        p_ign = shapes["probability_ignore_mask"].float()
        t_mask = shapes["threshold_mask"].float()
        t_ign = shapes["threshold_ignore_mask"].float()

        positive = p_mask * p_ign
        negative = (1.0 - p_mask) * p_ign
        n_pos = positive.sum()
        n_neg = torch.minimum(negative.sum(), n_pos * self.negative_ratio)

        bce = -(p_mask * torch.log(prob) + (1.0 - p_mask) *
                torch.log(1.0 - prob))
        pos_loss = (bce * positive).sum()
        neg_sorted = torch.sort((bce * negative).reshape(-1),
                                descending=True).values
        rank = torch.arange(neg_sorted.shape[0], device=neg_sorted.device,
                            dtype=torch.float32)
        neg_loss = torch.where(rank < n_neg, neg_sorted, 0.0).sum()
        count = n_pos + n_neg
        prob_loss = torch.where(count > 0, (pos_loss + neg_loss) /
                                torch.clamp(count, min=1.0), 0.0)

        t_den = global_sum(t_ign.sum())
        thresh_loss = torch.where(
            t_den > 0, (torch.abs(thresh - t_mask) * t_ign).sum() /
            per_rank(torch.clamp(t_den, min=1.0)), 0.0)

        inter = (binary * p_mask * p_ign).sum()
        union = (binary * p_ign).sum() + (p_mask * p_ign).sum()
        binary_loss = torch.where(
            (n_pos > 0) & (inter > 0) & (union > 0),
            1.0 - 2.0 * inter / torch.clamp(union, min=1e-8), 0.0)

        return {
            "probability_map_loss": self.probability_weight * prob_loss,
            "threshold_map_loss": self.threshold_weight * thresh_loss,
            "binary_map_loss": self.binary_weight * binary_loss,
        }
