"""ImageNet-21K semantic-softmax evaluation (counterpart of
``tools/test_imagenet21k_classification.py``):

    python -m simpleaicv_tpu_torch.tools.test_imagenet21k_classification \
        --work-dir <dir>

reads ``<dir>/test_config.py``, restores ``trained_model_path`` onto the
seeded model and logs, per hierarchy level of the test set's semantic tree,
the top-1 accuracy over the valid labels, then those hits pooled over the
levels ("overall semantic acc"). The semantic labels come as in
``train_imagenet21k_classification``. It runs on the card, or on the CPU
under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.logging_utils import get_logger
from ..core.platform import device_from_env
from ..core.trainer import batch_to_device
from ..data.loader import DataLoader
from ..models.common import init_params, resolve_device
from .common import load_test_config, parse_work_dir, restore_trained_params
from .train_imagenet21k_classification import SemanticTree


def main(argv=None):
    args = parse_work_dir("ImageNet-21K semantic-softmax evaluation", argv)
    config = load_test_config(args)
    logger = get_logger("test")
    device = resolve_device(device_from_env())

    tree = SemanticTree(config.test_dataset)
    model = init_params(config.model, torch.Generator().manual_seed(
        getattr(config, "seed", 0)))
    ckpt_path = getattr(config, "trained_model_path", "")
    if ckpt_path:
        n = restore_trained_params(ckpt_path, model)
        logger.info(f"loaded {n} tensors from {ckpt_path}")
    model.to(device).eval()

    loader = DataLoader(config.test_dataset, config.batch_size,
                        config.test_collater, shuffle=False, drop_last=False,
                        num_workers=getattr(config, "num_workers", 4))
    levels = len(tree.indices)
    correct, total = np.zeros(levels), np.zeros(levels)
    with torch.no_grad():
        for batch in loader:
            batch = batch_to_device(batch, device)
            out = model(batch["image"])
            labels = tree.labels(batch)
            for level, logits in enumerate(tree.outputs(out)):
                lab = labels[:, level]
                valid = lab >= 0
                hit = (torch.argmax(logits, dim=-1) == lab) & valid
                correct[level] += float(hit.sum())
                total[level] += float(valid.sum())
    per_level = correct / np.maximum(total, 1) * 100
    for level in range(levels):
        logger.info(f"level {level} semantic acc: {per_level[level]:.3f}")
    overall = correct.sum() / max(total.sum(), 1) * 100
    logger.info(f"overall semantic acc: {overall:.3f}")
    return {"per_level": per_level.tolist(), "acc": float(overall)}


if __name__ == "__main__":
    main()
