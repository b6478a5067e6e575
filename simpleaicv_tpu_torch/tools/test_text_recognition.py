"""OCR text-recognition evaluation (counterpart of
``tools/test_text_recognition.py``):

    python -m simpleaicv_tpu_torch.tools.test_text_recognition --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint with its BatchNorm statistics) onto the seeded model and
reports the string accuracy, the LCS precision and recall and 1 - NED
once. It runs on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..models.common import init_params, resolve_device
from ..tasks import text_recognition as tr
from .common import load_test_config, parse_work_dir, restore_trained_params


def main(argv=None):
    """Returns the string metrics and 'key_metric' (the accuracy), x 100."""
    args = parse_work_dir("text-recognition evaluation", argv)
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
    stats = tr.evaluate_text_recognition(
        model, loader, config.converter,
        lambda batch: batch_to_device(batch, device))
    for k, v in stats.items():
        logger.info(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
