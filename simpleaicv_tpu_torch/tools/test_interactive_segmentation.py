"""SAM interactive-segmentation evaluation (counterpart of
``tools/test_interactive_segmentation.py``):

    python -m simpleaicv_tpu_torch.tools.test_interactive_segmentation --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` (a port
checkpoint, for example ``checkpoints/best``) onto the seeded model, and
logs the point-prompt best-mask IoU, precision and recall over the test
set. It runs on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..models.common import init_params, resolve_device
from ..tasks import interactive_segmentation as sam_task
from .common import load_test_config, parse_work_dir, restore_trained_params


def main(argv=None):
    """Returns the metrics: {'iou', 'precision', 'recall'}."""
    args = parse_work_dir("SAM interactive-segmentation evaluation", argv)
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

    predict = sam_task.make_predict_best_mask_fn()
    loader = DataLoader(config.test_dataset, config.batch_size,
                        config.test_collater, shuffle=False, drop_last=False,
                        num_workers=getattr(config, "num_workers", 4))
    meter = sam_task.SegmentationEvalMeter()
    for batch in loader:
        b = batch_to_device(batch, device)
        pred = (predict(model, b["image"], b["prompt_point"])[:, 0]
                > 0).float()
        gt = b["mask"]
        if gt.shape[-2:] != pred.shape[-2:]:  # gt at input res, pred at /4
            f = gt.shape[-1] // pred.shape[-1]
            gt = gt[:, ::f, ::f]
        meter.update(pred, gt)
    metrics = meter.compute()
    for k, v in metrics.items():
        logger.info(f"{k}: {v}")
    return metrics


if __name__ == "__main__":
    main()
