"""Detection evaluation (counterpart of ``tools/test_detection.py``):

    python -m simpleaicv_tpu_torch.tools.test_detection --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint, for example ``checkpoints/best``) onto the seeded model, logs
its MACs and parameters, and runs the COCO evaluation once with the
config's ``decoder``: a DETR-family one (which takes the collater's 'size')
or a dense one (RetinaNet, FCOS). It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``. The face-detection evaluation runs the same
way over one class.
"""

from __future__ import annotations

import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.profile import compute_macs_and_params, format_macs_params
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..models.common import init_params, resolve_device
from ..tasks import detection
from .common import load_test_config, parse_work_dir, restore_trained_params


def evaluate(description: str, argv=None, num_classes=None):
    """Returns the COCO statistics and 'key_metric' (mAP x 100), over
    ``num_classes`` classes (default: the config's)."""
    args = parse_work_dir(description, argv)
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
    stats = detection.evaluate_coco(
        model, config.decoder, loader,
        config.num_classes if num_classes is None else num_classes,
        lambda batch: batch_to_device(batch, device))
    for k, v in stats.items():
        logger.info(f"{k}: {v}")
    return stats


def main(argv=None):
    return evaluate("detection evaluation", argv)


if __name__ == "__main__":
    main()
