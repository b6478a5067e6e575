"""SAM interactive-segmentation training (counterpart of
``tools/train_interactive_segmentation.py``):

    python -m simpleaicv_tpu_torch.tools.train_interactive_segmentation --work-dir <dir>

Each batch takes one prompt kind, drawn from the global ``random`` by the
config's ``prompt_probs``; a point batch takes ``decoder_point_iters``
optimizer steps with a no-grad best-mask prediction and one new click at an
error pixel between two steps (``train_batch``). Every epoch evaluates the
point-prompt best-mask IoU over each named test set, reduced on the device;
the best checkpoint is chosen by the IoU over all of them. It runs on the
card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import random

import torch

from ..core.engine import step_generator
from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import interactive_segmentation as sam_task
from .common import load_train_config, parse_work_dir

__all__ = ["SAMTrainer", "draw_prompt_kind", "keep_prompt", "train_batch",
           "main"]

DEFAULT_PROMPT_PROBS = {"point": 0.5, "box": 0.25, "mask": 0.25}


def draw_prompt_kind(prompt_probs, rng=random) -> str:
    """"point", "box" or "mask", one draw of ``rng.random()``."""
    r = rng.random()
    if r < prompt_probs["point"]:
        return "point"
    if r < prompt_probs["point"] + prompt_probs["box"]:
        return "box"
    return "mask"


def keep_prompt(batch, kind: str) -> dict:
    """``batch`` with every prompt entry but ``prompt_<kind>`` set to
    None."""
    return {k: (v if k not in sam_task.PROMPT_KEYS or k == f"prompt_{kind}"
                else None) for k, v in batch.items()}


def train_batch(step, state, predict, batch, kind: str, point_iters: int,
                click_generator, seed: int = 0, observe=None):
    """One batch of the per-batch loop on the device: one optimizer step,
    or ``point_iters`` of them on a point batch with a no-grad best-mask
    prediction and one new click at an error pixel between two steps (the
    click's generator reseeded from (seed, step)). ``observe(what, value)``,
    if given, is called after each step ("step", its metrics) and each
    refinement ("refine", the new points). Returns (state, the last step's
    metrics)."""
    batch = keep_prompt(batch, kind)
    iters = point_iters if kind == "point" else 1
    metrics = None
    for it in range(iters):
        state, metrics = step(state, batch, seed)
        if observe is not None:
            observe("step", metrics)
        if it + 1 < iters:
            masks = predict(state.model, batch["image"],
                            batch["prompt_point"])
            points = sam_task.sample_error_region_points(
                masks, batch["mask"], batch["prompt_point"],
                generator=step_generator(click_generator, seed, state.step))
            batch = dict(batch, prompt_point=points)
            if observe is not None:
                observe("refine", points)
    return state, metrics


@torch.no_grad()
def _iou_stats(pred, mask):
    """The summed best-mask IoU of a batch and its size, on the device."""
    pred_bin = (pred[:, 0] > 0.0).float()
    gt = mask.float()
    if gt.dim() == 4:
        gt = gt[:, 0] if gt.shape[1] == 1 else gt[..., 0]
    inter = (pred_bin * gt).sum((1, 2))
    union = pred_bin.sum((1, 2)) + gt.sum((1, 2)) - inter
    return (inter / union.clamp(min=1.0)).sum(), pred_bin.shape[0]


class SAMTrainer(Trainer):

    def __init__(self, config, work_dir, device="cuda"):
        self.prompt_probs = getattr(config, "prompt_probs",
                                    DEFAULT_PROMPT_PROBS)
        self.decoder_point_iters = getattr(config, "decoder_point_iters", 1)
        super().__init__(config, work_dir,
                         make_loss_fn=sam_task.make_loss_fn,
                         evaluate=self._evaluate, device=device)
        self.predict = sam_task.make_predict_best_mask_fn()
        self.click_generator = torch.Generator(device=self.device)

    def train_batch(self, batch) -> dict:
        kind = draw_prompt_kind(self.prompt_probs)
        self.state, metrics = train_batch(
            self.train_step, self.state, self.predict, batch, kind,
            self.decoder_point_iters, self.click_generator, self.seed)
        return metrics

    def _evaluate(self, eval_step, model, loader, to_device):
        """Point-prompt best-mask IoU over every named test set, and over
        all of them together (the key metric)."""
        del eval_step, loader
        metrics = {}
        tot_sum, tot_n = 0.0, 0
        for name, dl in self.test_loaders.items():
            iou_sum = torch.zeros((), device=self.device)
            n = 0
            for batch in dl:
                b = to_device(batch)
                s, c = _iou_stats(self.predict(model, b["image"],
                                               b["prompt_point"]), b["mask"])
                iou_sum += s
                n += c
            iou_sum = float(iou_sum)
            metrics[f"iou/{name}"] = iou_sum / max(n, 1)
            tot_sum += iou_sum
            tot_n += n
        miou = tot_sum / max(tot_n, 1)
        metrics.update({"iou": miou, "key_metric": miou})
        return metrics


def main(argv=None):
    args = parse_work_dir("SAM interactive-segmentation training", argv)
    trainer = SAMTrainer(load_train_config(args), args.work_dir,
                         device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
