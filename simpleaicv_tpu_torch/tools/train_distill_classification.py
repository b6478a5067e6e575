"""Distillation training (counterpart of
``tools/train_distill_classification.py``):

    python -m simpleaicv_tpu_torch.tools.train_distill_classification --work-dir <dir>

where ``<dir>/train_config.py`` builds a ``KDTeacherStudent`` model and
lists its losses in ``loss_list``; each epoch evaluates the student's head
(top-1, top-5), and the best checkpoint is the best student top-1. It runs
on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import classification, distillation
from .common import load_train_config, parse_work_dir


def main(argv=None):
    args = parse_work_dir("distillation training", argv)
    config = load_train_config(args)
    criterion_list = distillation.build_criterion_list(config.loss_list)
    config.train_criterion = None
    trainer = Trainer(
        config, args.work_dir,
        make_loss_fn=lambda _criterion: distillation.make_loss_fn(
            criterion_list),
        make_eval_fn=lambda: classification.make_eval_fn(output_index=1),
        evaluate=classification.evaluate, device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
