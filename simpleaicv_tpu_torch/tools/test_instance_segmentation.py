"""Instance-segmentation evaluation (counterpart of
``tools/test_instance_segmentation.py``):

    python -m simpleaicv_tpu_torch.tools.test_instance_segmentation --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint, for example ``checkpoints/best``, with its BatchNorm
statistics, which the JAX CLI does not restore) onto the seeded model and
runs the COCO mask evaluation once with the config's ``decoder``. It runs on
the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..models.common import init_params, resolve_device
from ..tasks import instance_segmentation as inst
from .common import load_test_config, parse_work_dir, restore_trained_params


def main(argv=None):
    """Returns the COCO 'segm' statistics and 'key_metric' (mAP x 100)."""
    args = parse_work_dir("instance-segmentation evaluation", argv)
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

    loader = DataLoader(config.test_dataset, config.batch_size,
                        config.test_collater, shuffle=False, drop_last=False,
                        num_workers=getattr(config, "num_workers", 4))
    stats = inst.evaluate_coco_segm(
        model, config.decoder, loader, config.num_classes,
        lambda batch: batch_to_device(batch, device))
    for k, v in stats.items():
        logger.info(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
