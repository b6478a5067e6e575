"""Text-recognition losses (counterpart of
``simpleaicv_tpu/losses/text_recognition.py``): ``CTCLoss`` (optionally
focal-weighted, each sequence's loss divided by its target length and by
the batch) and ``ACELoss`` (aggregation cross-entropy).

``CTCLoss`` is ``F.ctc_loss(reduction="none")`` on the f32 log-softmax,
every input length T. The JAX package's optax gives an alignment that
cannot be made (a target longer than T allows) a loss near 1e5 and masks
every loss that is not finite or not under 1e5 to 0; torch gives such a
sequence an infinite loss, which ``zero_infinity`` sets to 0 with its
gradient, and the same mask follows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import LOSSES

__all__ = ["CTCLoss", "ACELoss"]


@LOSSES.register()
class CTCLoss:

    def __init__(self, blank_index: int = 0, use_focal_weight: bool = False,
                 gamma: float = 2.0):
        self.blank_index = blank_index
        self.use_focal_weight = use_focal_weight
        self.gamma = gamma

    def __call__(self, preds, targets, target_lengths):
        """preds [B, T, C] logits; targets [B, N] int (0-padded);
        target_lengths [B]. Returns the f32 scalar."""
        b, t, _ = preds.shape
        log_probs = F.log_softmax(preds.float(), dim=-1).transpose(0, 1)
        lengths = target_lengths.long()
        per_seq = F.ctc_loss(
            log_probs, targets.long(),
            torch.full((b,), t, dtype=torch.long, device=preds.device),
            lengths, blank=self.blank_index, reduction="none",
            zero_infinity=True)
        per_seq = torch.where(torch.isfinite(per_seq) & (per_seq < 1e5),
                              per_seq, 0.0)
        if self.use_focal_weight:
            pt = torch.exp(-per_seq)
            per_seq = torch.pow(1.0 - pt, self.gamma) * per_seq
        per_seq = per_seq / torch.clamp(lengths.float(), min=1.0) / b
        return per_seq.sum()


@LOSSES.register()
class ACELoss:
    """Matches the mean predicted class distribution over time to the
    targets' class counts, the blank taking the unlabelled steps."""

    def __init__(self, blank_index: int = 0):
        self.blank_index = blank_index

    def __call__(self, preds, targets, target_lengths):
        """preds [B, T, C]; targets [B, N] (0 = pad or blank)."""
        b, t, c = preds.shape
        p_mean = torch.softmax(preds.float(), dim=-1).mean(dim=1)
        idx = torch.clamp(targets.long(), 0, c - 1)
        counts = torch.zeros(b, c, device=preds.device).scatter_add_(
            1, idx, torch.ones(idx.shape, device=preds.device))
        counts[:, self.blank_index] = 0.0
        counts[:, self.blank_index] = t - counts.sum(dim=-1)
        target_dist = counts / t
        loss = -(target_dist * torch.log(torch.clamp(p_mean, min=1e-10))
                 ).sum(dim=-1)
        return loss.mean()
