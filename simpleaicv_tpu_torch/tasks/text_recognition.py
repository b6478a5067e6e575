"""Text-recognition task adapter (counterpart of
``simpleaicv_tpu/tasks/text_recognition.py``): the CTC loss of a train
step, the string metrics (LCS, Levenshtein distance, 1 - normalised edit
distance) and the evaluation: the model in eval mode without gradients,
the argmax over classes on the device, the [B, T] indices copied to the
host and decoded greedily."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["make_loss_fn", "lcs_length", "edit_distance",
           "normalized_edit_similarity", "evaluate_text_recognition"]


def make_loss_fn(criterion) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine: the
    criterion on the model's logits, 'targets' and 'target_lengths'; the
    Transformer encoder's dropout draws from ``generator``."""

    def loss_fn(model, batch, generator, train):
        preds = model(batch["image"], train=train,
                      generator=generator if train else None)
        return criterion(preds, batch["targets"],
                         batch["target_lengths"]), {}

    return loss_fn


def lcs_length(a: str, b: str) -> int:
    """The longest common subsequence's length."""
    if not a or not b:
        return 0
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            if a[i - 1] == b[j - 1]:
                dp[i, j] = dp[i - 1, j - 1] + 1
            else:
                dp[i, j] = max(dp[i - 1, j], dp[i, j - 1])
    return int(dp[len(a), len(b)])


def edit_distance(a: str, b: str) -> int:
    """The Levenshtein distance."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1, dtype=np.int32)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, np.int32)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


def normalized_edit_similarity(pred: str, gt: str) -> float:
    """ICDAR 2019's 1 - NED term of one sample: 1 - ED / max length, 0 when
    either string is empty."""
    if len(pred) == 0 or len(gt) == 0:
        return 0.0
    return 1.0 - edit_distance(pred, gt) / max(len(gt), len(pred))


@torch.no_grad()
def evaluate_text_recognition(model, loader, converter,
                              to_device: Callable) -> dict:
    """String accuracy (spaces dropped, case ignored), LCS character
    precision and recall and mean 1 - NED, each x 100; 'key_metric' the
    accuracy. The model's own mode is as before afterwards."""
    was_training = model.training
    model.eval()
    n_correct = n_total = 0
    lcs_sum = pred_chars = gt_chars = 0
    ne_sum = 0.0
    try:
        for batch in loader:
            preds = model(to_device({"image": batch["image"]})["image"])
            idxs = torch.argmax(preds, dim=-1).cpu().numpy()
            for pred, gt in zip(converter.decode(idxs), batch["texts"]):
                pred_n = pred.replace(" ", "").lower()
                gt_n = gt.replace(" ", "").lower()
                if not gt_n:
                    continue
                n_total += 1
                n_correct += int(pred_n == gt_n)
                ne_sum += normalized_edit_similarity(pred_n, gt_n)
                lcs_sum += lcs_length(pred, gt)
                pred_chars += len(pred)
                gt_chars += len(gt)
    finally:
        model.train(was_training)
    return {"str_acc": n_correct / max(n_total, 1) * 100,
            "lcs_precision": lcs_sum / max(pred_chars, 1) * 100,
            "lcs_recall": lcs_sum / max(gt_chars, 1) * 100,
            "edit_distance_1ned": ne_sum / max(n_total, 1) * 100,
            "key_metric": n_correct / max(n_total, 1) * 100}
