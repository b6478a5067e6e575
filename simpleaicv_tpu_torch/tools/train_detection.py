"""Dense detection training (counterpart of ``tools/train_detection.py``;
RetinaNet and FCOS):

    python -m simpleaicv_tpu_torch.tools.train_detection --work-dir <dir>

trains ``<dir>/train_config.py`` with the detection adapter: the config's
``train_criterion`` on the model's per-level predictions and the pixel
'annots'. When the config has a ``test_dataset`` and a ``decoder``, every
epoch ends with the COCO evaluation, and the best checkpoint is chosen by
its mAP. The face-detection CLI trains the same way over one class, the
DETR-family CLI with its own loss function. It runs on the card, or on the
CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import detection
from .common import load_train_config, parse_work_dir


def train(description: str, argv=None, num_classes=None,
          make_loss_fn=detection.make_loss_fn):
    """Trains the work dir's config with ``make_loss_fn``'s loss; returns
    the best key metric. The evaluation counts ``num_classes`` classes
    (default: the config's)."""
    args = parse_work_dir(description, argv)
    config = load_train_config(args)
    classes = config.num_classes if num_classes is None else num_classes

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        return detection.evaluate_coco(model, config.decoder, loader,
                                       classes, to_device)

    has_eval = (getattr(config, "test_dataset", None) is not None
                and getattr(config, "decoder", None) is not None)
    trainer = Trainer(config, args.work_dir,
                      make_loss_fn=make_loss_fn,
                      evaluate=evaluate if has_eval else None,
                      device=device_from_env())
    return trainer.run()


def main(argv=None):
    return train("detection training", argv)


if __name__ == "__main__":
    main()
