"""Semantic-segmentation training (counterpart of
``tools/train_semantic_segmentation.py``):

    python -m simpleaicv_tpu_torch.tools.train_semantic_segmentation --work-dir <dir>

trains ``<dir>/train_config.py`` with the semantic-segmentation adapter:
the config's ``train_criterion`` on the logits and the masks, and, with a
``test_dataset``, the class-area evaluation every epoch (mIoU as the key
metric, ``num_classes`` and ``ignore_index`` from the config). The face- and
human-parsing CLIs train the same way. It runs on the card, or on the CPU
under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import semantic_segmentation as seg
from .common import load_train_config, parse_work_dir


def train(description: str, argv=None):
    """Trains the work dir's config; returns the best key metric."""
    args = parse_work_dir(description, argv)
    config = load_train_config(args)
    ignore_index = getattr(config, "ignore_index", 255)
    trainer = Trainer(
        config, args.work_dir,
        make_loss_fn=seg.make_loss_fn,
        make_eval_fn=lambda: seg.make_eval_fn(config.num_classes,
                                              ignore_index),
        evaluate=seg.make_evaluate(config.num_classes),
        device=device_from_env())
    return trainer.run()


def main(argv=None):
    return train("semantic-segmentation training", argv)


if __name__ == "__main__":
    main()
