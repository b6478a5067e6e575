"""DDPM evaluation (counterpart of ``tools/test_diffusion_model.py``):

    python -m simpleaicv_tpu_torch.tools.test_diffusion_model --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint, for example ``checkpoints/best``) onto the seeded UNet, samples
``generate_num`` images (16 by default) with the config's ``sampler`` from
the generator seeded with ``seed`` and writes them to
``<dir>/generated/<i>.png``. With ``inception_weights_path`` and a
``test_dataset`` it also logs the FID against as many test images and the
Inception Score. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.png import write_png
from ..models.common import init_params, resolve_device
from ..tasks import diffusion
from .common import load_test_config, parse_work_dir, restore_trained_params
from .train_diffusion_model import to_uint8


def main(argv=None):
    """Returns {'generated': the count of images written, and 'fid',
    'is_mean', 'is_std' when they were computed}."""
    args = parse_work_dir("diffusion evaluation", argv)
    config = load_test_config(args)
    logger = get_logger("test")
    device = resolve_device(device_from_env())
    seed = getattr(config, "seed", 0)

    model = init_params(config.model, torch.Generator().manual_seed(seed))
    ckpt_path = getattr(config, "trained_model_path", "")
    if ckpt_path:
        n = restore_trained_params(ckpt_path, model)
        logger.info(f"loaded {n} tensors from {ckpt_path}")
    model.to(device)

    s = config.input_image_size
    n = getattr(config, "generate_num", 16)
    generate = diffusion.make_generate_fn(model, config.sampler,
                                          (n, s, s, 3), device=device)
    images = to_uint8(generate(torch.Generator(device).manual_seed(seed)))
    out_dir = os.path.join(args.work_dir, "generated")
    os.makedirs(out_dir, exist_ok=True)
    for i, img in enumerate(images):
        write_png(os.path.join(out_dir, f"{i}.png"), img)
    logger.info(f"saved {len(images)} generated images to {out_dir}")
    stats = {"generated": len(images)}

    inception_weights = getattr(config, "inception_weights_path", "")
    if inception_weights and getattr(config, "test_dataset", None) is not None:
        from ..evaluation.fid_is import (compute_fid, compute_inception_score,
                                         make_inception_feature_fn)
        feat_fn = make_inception_feature_fn(inception_weights, device=device)
        # the feature function takes [0, 1]; samples and data are [-1, 1]
        fake_feats, fake_probs = feat_fn(images.astype(np.float32) / 255.0)
        reals = [(np.asarray(config.test_dataset[i]["image"], np.float32)
                  + 1.0) / 2 for i in range(min(len(config.test_dataset), n))]
        real_feats, _ = feat_fn(np.stack(reals))
        stats["fid"] = compute_fid(real_feats, fake_feats)
        stats["is_mean"], stats["is_std"] = compute_inception_score(
            fake_probs)
        logger.info(f"FID: {stats['fid']:.3f} IS: {stats['is_mean']:.3f}"
                    f"+-{stats['is_std']:.3f}")
    return stats


if __name__ == "__main__":
    main()
