"""SAM-matting training (counterpart of
``tools/train_interactive_matting.py``):

    python -m simpleaicv_tpu_torch.tools.train_interactive_matting --work-dir <dir>

trains ``<dir>/train_config.py`` (a ``SAMMatting`` model and one of the
``SAMMatting*Loss`` stacks) on the collater's point and box prompts, with
the SAD, MAE and MSE of the fused alpha every epoch when it has a
``test_dataset`` (a multi-level model's level with the highest predicted
IoU); the best checkpoint has the least SAD. The foreground and background
maps of the composition term are image x alpha and image x (1 - alpha),
made on the device. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import torch

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks.matting import alpha_error_sums, make_evaluate
from .common import load_train_config, parse_work_dir

__all__ = ["make_loss_fn", "make_eval_fn", "best_level", "evaluate", "main"]


def _forward(model, batch, train):
    prompts = {"prompt_point": batch.get("prompt_point"),
               "prompt_box": batch.get("prompt_box"), "prompt_mask": None}
    return model(batch["image"], prompts, train)


def make_loss_fn(criterion):
    """``loss_fn(model, batch, generator, train)`` for the engine; returns
    the sum of the criterion's terms and the terms as metrics."""

    def loss_fn(model, batch, generator, train):
        del generator  # SAM matting draws nothing in its forward
        preds = _forward(model, batch, train)
        image = batch["image"].float()
        alpha = batch["alpha"].float()
        fg_map = image * alpha[..., None]
        bg_map = image * (1.0 - alpha[..., None])
        loss_dict = criterion(image, preds,
                              (alpha, batch["trimap"], fg_map, bg_map))
        total = torch.zeros((), dtype=torch.float32, device=image.device)
        for value in loss_dict.values():
            total = total + value
        return total, dict(loss_dict)

    return loss_fn


def best_level(fused, iou):
    """A multi-level fused alpha [B, L, H, W, 1] at each sample's level of
    the highest predicted IoU (the first on a tie) -> [B, H, W, 1]; a
    one-level one as it is."""
    if fused.dim() != 5:
        return fused
    sel = torch.argmax(iou, dim=1)
    return fused[torch.arange(fused.shape[0], device=fused.device), sel]


def make_eval_fn():
    """The SAD / 1000, MAE and MSE sums of the fused alpha of one batch."""

    def eval_fn(model, batch, generator, train):
        del generator, train
        _, _, fused, iou = _forward(model, batch, False)
        return alpha_error_sums(best_level(fused, iou)[..., 0],
                                batch["alpha"])

    return eval_fn


evaluate = make_evaluate()


def main(argv=None):
    """Returns the best key metric (minus the mean SAD, or minus the loss
    without a test set)."""
    args = parse_work_dir("SAM-matting training", argv)
    trainer = Trainer(load_train_config(args), args.work_dir,
                      make_loss_fn=make_loss_fn, make_eval_fn=make_eval_fn,
                      evaluate=evaluate, device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
