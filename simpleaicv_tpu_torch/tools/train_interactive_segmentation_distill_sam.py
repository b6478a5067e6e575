"""Whole-SAM distillation (counterpart of
``tools/train_interactive_segmentation_distill_sam.py``):

    python -m simpleaicv_tpu_torch.tools.train_interactive_segmentation_distill_sam --work-dir <dir>

trains ``<dir>/train_config.py``'s ``SAMDistillModel``: the frozen teacher
and the student run on the same images and the collater's point and box
prompts, and the loss is the sum of ``train_criterion``'s terms
(``SAMDistillLoss``: focal and dice on the teacher's binarised masks, MSE
on the IoU predictions); with no evaluation the best checkpoint has the
least loss. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import torch

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from .common import load_train_config, parse_work_dir

__all__ = ["make_loss_fn", "main"]


def make_loss_fn(criterion):
    """``loss_fn(model, batch, generator, train)``: the sum of
    criterion(teacher, student)'s terms, and the terms as metrics."""

    def loss_fn(model, batch, generator, train):
        del generator
        prompts = {"prompt_point": batch.get("prompt_point"),
                   "prompt_box": batch.get("prompt_box"),
                   "prompt_mask": None}
        tea, stu = model(batch["image"], prompts, (0, 1, 2, 3), train)
        loss_dict = criterion(tea, stu)
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["image"].device)
        for value in loss_dict.values():
            total = total + value
        return total, dict(loss_dict)

    return loss_fn


def main(argv=None):
    """Returns the best key metric (minus the loss)."""
    args = parse_work_dir("whole-SAM distillation", argv)
    trainer = Trainer(load_train_config(args), args.work_dir,
                      make_loss_fn=make_loss_fn, device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
