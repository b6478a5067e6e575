"""OCR text-recognition (CTC) training (counterpart of
``tools/train_text_recognition.py``):

    python -m simpleaicv_tpu_torch.tools.train_text_recognition --work-dir <dir>

trains ``<dir>/train_config.py`` on its CTC criterion. When the config has
a ``test_dataset``, every epoch ends with the string accuracy, the LCS
precision and recall and 1 - NED of the greedy decode (the config's
``converter``), and the best checkpoint is chosen by the accuracy. It runs
on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import text_recognition as tr
from .common import load_train_config, parse_work_dir


def main(argv=None):
    """Returns the best key metric (the string accuracy x 100, or minus the
    loss without an evaluation)."""
    args = parse_work_dir("text-recognition training", argv)
    config = load_train_config(args)

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        return tr.evaluate_text_recognition(model, loader, config.converter,
                                            to_device)

    has_eval = getattr(config, "test_dataset", None) is not None
    trainer = Trainer(config, args.work_dir, make_loss_fn=tr.make_loss_fn,
                      evaluate=evaluate if has_eval else None,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
