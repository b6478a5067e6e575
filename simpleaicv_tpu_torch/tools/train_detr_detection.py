"""DETR-family detection training (counterpart of
``tools/train_detr_detection.py``; DETR and DINO-DETR):

    python -m simpleaicv_tpu_torch.tools.train_detr_detection --work-dir <dir>

When the config has a ``test_dataset`` and a ``decoder``, every epoch ends
with the COCO evaluation, and the best checkpoint is chosen by its mAP. It
runs on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.

The JAX tool's ``DETRTrainer`` only initialises the model through a forward
pass with denoising queries, so that the parameters those queries use
exist; the port's modules create every parameter when they are built and
``init_params`` fills them without a forward pass, so the plain ``Trainer``
serves.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import detection
from .common import load_train_config, parse_work_dir


def main(argv=None):
    args = parse_work_dir("DETR-family detection training", argv)
    config = load_train_config(args)

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        return detection.evaluate_coco(model, config.decoder, loader,
                                       config.num_classes, to_device)

    has_eval = (getattr(config, "test_dataset", None) is not None
                and getattr(config, "decoder", None) is not None)
    trainer = Trainer(config, args.work_dir,
                      make_loss_fn=detection.make_detr_loss_fn,
                      evaluate=evaluate if has_eval else None,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
