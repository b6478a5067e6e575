"""Human-matting task adapter (counterpart of
``simpleaicv_tpu/tasks/matting.py``): the global/local/fusion loss stack and
the SAD, MAE and MSE of an evaluation, for PFAN matting.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel.mesh import sum_over_ranks

__all__ = ["make_loss_fn", "make_eval_fn", "make_evaluate",
           "alpha_error_sums"]


def _route_loss(name, loss, preds, batch):
    """One loss of the stack on its inputs, routed by its name's prefix:
    Global (and the reference's misspelt Gloabel) get (trimap prediction,
    trimap), Local (alpha prediction, alpha, trimap), Composition (fused,
    alpha, image) and every other one, Fusion, (fused, alpha)."""
    g, l, f = preds
    if name.startswith(("Global", "Gloabel")):
        return loss(g, batch["trimap"])
    if name.startswith("Local"):
        return loss(l, batch["alpha"], batch["trimap"])
    if name.startswith("Composition"):
        return loss(f, batch["alpha"], batch["image"])
    return loss(f, batch["alpha"])


def make_loss_fn(criterion_cfg) -> Callable:
    """``loss_fn(model, batch, generator, train)`` for the engine over a
    PFAN matting model; criterion_cfg: {name: (ratio, loss)}. Returns the
    weighted sum and each loss under its name."""

    def loss_fn(model, batch, generator, train):
        preds = model(batch["image"], train=train,
                      generator=generator if train else None)
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["image"].device)
        metrics = {}
        for name, (ratio, loss) in criterion_cfg.items():
            v = _route_loss(name, loss, preds, batch)
            metrics[name] = v
            total = total + ratio * v
        return total, metrics

    return loss_fn


def alpha_error_sums(pred, alpha):
    """The batch's SAD / 1000 and its sums over the images of the MAE and
    the MSE of ``pred`` against ``alpha`` (both [B, H, W]), and the image
    count."""
    diff = pred.float() - alpha.float()
    return {"sad_sum": diff.abs().sum() / 1000.0,
            "mae_sum": diff.abs().mean(dim=(1, 2)).sum(),
            "mse_sum": (diff**2).mean(dim=(1, 2)).sum(),
            "n": torch.tensor(float(pred.shape[0]), device=pred.device)}


def make_eval_fn() -> Callable:
    """The eval function of one batch: ``alpha_error_sums`` of the fused
    alpha (the reference's Grad and Conn are host-side and left out, as in
    the JAX package)."""

    def eval_fn(model, batch, generator, train):
        del generator, train
        _, _, fused = model(batch["image"], train=False)
        return alpha_error_sums(fused[..., 0], batch["alpha"])

    return eval_fn


def make_evaluate():
    """``evaluate(eval_step, model, loader, shard_fn)``: the mean SAD, MAE
    and MSE over the images of the eval step's ``alpha_error_sums``;
    ``key_metric`` is minus the SAD. The sums are summed over the
    ranks."""

    def evaluate(eval_step, model, loader, shard_fn) -> dict:
        sums = dict.fromkeys(("sad_sum", "mae_sum", "mse_sum", "n"), 0.0)
        for batch in loader:
            m = eval_step(model, shard_fn(batch))
            for k in sums:
                sums[k] += float(m[k])
        sums = dict(zip(sums, sum_over_ranks(list(sums.values())).tolist()))
        n = max(sums["n"], 1.0)
        sad = sums["sad_sum"] / n
        return {"sad": sad, "mae": sums["mae_sum"] / n,
                "mse": sums["mse_sum"] / n, "key_metric": -sad}

    evaluate.sums_over_ranks = True
    return evaluate
