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

from ..tasks import detection
from .train_detection import train


def main(argv=None):
    return train("DETR-family detection training", argv,
                 make_loss_fn=detection.make_detr_loss_fn)


if __name__ == "__main__":
    main()
