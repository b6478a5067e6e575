"""Classification evaluation (counterpart of ``tools/test_classification.py``):

    python -m simpleaicv_tpu_torch.tools.test_classification --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint, for example ``checkpoints/best``) onto the seeded model, and
logs the MACs and parameters, then top-1 and top-5. It runs on the card, or
on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.

Under ``torchrun`` each rank evaluates its share of the set and the
meters are summed over the ranks.
"""

from __future__ import annotations

import torch

from ..core.engine import make_eval_step
from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.profile import compute_macs_and_params, format_macs_params
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..models.common import init_params, resolve_device
from ..parallel.multihost import initialize_multihost
from ..tasks import classification
from .common import load_test_config, parse_work_dir, restore_trained_params


def main(argv=None):
    args = parse_work_dir("classification evaluation", argv)
    initialize_multihost()  # a no-op unless torchrun started it
    config = load_test_config(args)
    logger = get_logger("test")
    device = resolve_device(device_from_env())

    model = init_params(config.model, torch.Generator().manual_seed(
        getattr(config, "seed", 0)))
    ckpt_path = getattr(config, "trained_model_path", "")
    if ckpt_path:
        n = restore_trained_params(ckpt_path, model)
        logger.info(f"loaded {n} tensors from {ckpt_path}")
    model.to(device)

    s = config.input_image_size
    macs, params = compute_macs_and_params(
        model, torch.zeros((1, s, s, 3), device=device))
    logger.info(format_macs_params(macs, params))

    loader = DataLoader(config.test_dataset, config.batch_size,
                        config.test_collater, shuffle=False, drop_last=False,
                        num_workers=getattr(config, "num_workers", 4))
    metrics = classification.evaluate(
        make_eval_step(classification.make_eval_fn(), device), model, loader,
        lambda batch: batch_to_device(batch, device))
    logger.info(f"top1: {metrics['acc1']:.3f}% top5: {metrics['acc5']:.3f}%")
    return metrics


if __name__ == "__main__":
    main()
