"""DDPM training (counterpart of ``tools/train_diffusion_model.py``):

    python -m simpleaicv_tpu_torch.tools.train_diffusion_model --work-dir <dir>

trains ``<dir>/train_config.py``'s UNet on its ``train_criterion`` between
the predicted and the drawn noise of its ``trainer`` (a ``DDPMTrainer``),
conditioned on the labels with ``num_classes`` (and
``class_label_drop_prob``). With a ``sampler``, every epoch ends by sampling
``eval_sample_grid`` images (16 by default) and writing them as one square
grid to ``<dir>/samples/grid_NNNN.png``; the best checkpoint is the one of
the least loss. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.platform import device_from_env
from ..core.png import write_png
from ..core.trainer import Trainer
from ..tasks import diffusion
from .common import load_train_config, parse_work_dir


def image_grid(images, side: int):
    """The first side^2 of uint8 [N, s, s, 3] images as one
    [side * s, side * s, 3] grid, row by row."""
    s = images.shape[1]
    return images[:side * side].reshape(side, side, s, s, 3).transpose(
        0, 2, 1, 3, 4).reshape(side * s, side * s, 3)


def to_uint8(images) -> np.ndarray:
    """[-1, 1] images (a tensor) -> uint8 numpy."""
    images = images.float().clamp(-1, 1).cpu().numpy()
    return ((images + 1) * 127.5).astype(np.uint8)


def main(argv=None):
    """Returns the best key metric (minus the least loss)."""
    args = parse_work_dir("diffusion training", argv)
    config = load_train_config(args)
    s = config.input_image_size
    grid_n = getattr(config, "eval_sample_grid", 16)
    sampler = getattr(config, "sampler", None)
    grids = [0]

    def evaluate(eval_step, model, loader, to_device):
        """One sample grid from the generator seeded with the count of
        grids so far."""
        del eval_step, loader, to_device
        device = trainer.device
        generate = diffusion.make_generate_fn(model, sampler,
                                              (grid_n, s, s, 3),
                                              device=device)
        images = to_uint8(generate(torch.Generator(device).manual_seed(
            grids[0])))
        grids[0] += 1
        out_dir = os.path.join(args.work_dir, "samples")
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"grid_{grids[0]:04d}.png"),
                  image_grid(images, int(grid_n ** 0.5)))
        return {"sample_grids_saved": float(grids[0])}

    evaluate.needs_loader = False
    trainer = Trainer(
        config, args.work_dir,
        make_loss_fn=lambda criterion: diffusion.make_loss_fn(
            criterion, config.trainer,
            num_classes=getattr(config, "num_classes", None),
            class_label_drop_prob=getattr(config, "class_label_drop_prob",
                                          0.0)),
        evaluate=evaluate if sampler is not None and grid_n else None,
        device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
