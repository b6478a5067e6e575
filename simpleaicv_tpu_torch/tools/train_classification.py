"""Classification training (counterpart of ``tools/train_classification.py``):

    python -m simpleaicv_tpu_torch.tools.train_classification --work-dir <dir>

where ``<dir>`` holds ``train_config.py`` exposing ``class config``; the
checkpoints go to ``<dir>/checkpoints`` and the log to ``<dir>/log``. A run
over a directory with a latest checkpoint resumes after its epoch. It runs
on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import classification
from .common import load_train_config, parse_work_dir


def main(argv=None):
    args = parse_work_dir("classification training", argv)
    trainer = Trainer(load_train_config(args), args.work_dir,
                      make_loss_fn=classification.make_loss_fn,
                      make_eval_fn=classification.make_eval_fn,
                      evaluate=classification.evaluate,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
