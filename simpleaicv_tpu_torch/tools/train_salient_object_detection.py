"""Salient-object-detection training (counterpart of
``tools/train_salient_object_detection.py``):

    python -m simpleaicv_tpu_torch.tools.train_salient_object_detection --work-dir <dir>

trains ``<dir>/train_config.py`` on the weighted sum of its
``criterion_list``, with the thresholded IoU evaluation every epoch when it
has a ``test_dataset``. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import binary_segmentation as bseg
from .common import load_train_config, parse_work_dir


def main(argv=None):
    """Returns the best key metric (the mean IoU)."""
    args = parse_work_dir("salient-object-detection training", argv)
    config = load_train_config(args)
    criterion_list = config.criterion_list
    trainer = Trainer(
        config, args.work_dir,
        make_loss_fn=lambda _criterion: bseg.make_loss_fn(criterion_list),
        make_eval_fn=bseg.make_eval_fn,
        evaluate=bseg.make_evaluate(),
        device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
