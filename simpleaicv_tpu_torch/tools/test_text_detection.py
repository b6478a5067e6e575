"""OCR text-detection evaluation (counterpart of
``tools/test_text_detection.py``):

    python -m simpleaicv_tpu_torch.tools.test_text_detection --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint with its BatchNorm statistics, which the JAX CLI does not
restore) onto the seeded model and reports the polygon P/R/F1 at IoU 0.5
once (``DBNetDecoder``, or the config's ``decoder``). It runs on the card,
or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..data.text_detection import DBNetDecoder
from ..models.common import init_params, resolve_device
from ..tasks import text_detection as td
from .common import load_test_config, parse_work_dir, restore_trained_params


def main(argv=None):
    """Returns precision, recall, f1 and 'key_metric' (the F1), x 100."""
    args = parse_work_dir("text-detection evaluation", argv)
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
    stats = td.evaluate_polygons(
        model, getattr(config, "decoder", None) or DBNetDecoder(), loader,
        lambda batch: batch_to_device(batch, device))
    for k, v in stats.items():
        logger.info(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
