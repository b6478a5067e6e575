"""OCR text-detection (DBNet) training (counterpart of
``tools/train_text_detection.py``):

    python -m simpleaicv_tpu_torch.tools.train_text_detection --work-dir <dir>

trains ``<dir>/train_config.py`` on the sum of ``DBNetLoss``'s terms over
the model's maps and the collater's four target maps. When the config has
a ``test_dataset``, every epoch ends with the polygon P/R/F1 at IoU 0.5
(``DBNetDecoder``, or the config's ``decoder``), and the best checkpoint
is chosen by the F1. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..data.text_detection import DBNetDecoder
from ..tasks import text_detection as td
from .common import load_train_config, parse_work_dir


def main(argv=None):
    """Returns the best key metric (the F1 x 100, or minus the loss without
    an evaluation)."""
    args = parse_work_dir("text-detection training", argv)
    config = load_train_config(args)
    decoder = getattr(config, "decoder", None) or DBNetDecoder()

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        return td.evaluate_polygons(model, decoder, loader, to_device)

    has_eval = getattr(config, "test_dataset", None) is not None
    trainer = Trainer(config, args.work_dir, make_loss_fn=td.make_loss_fn,
                      evaluate=evaluate if has_eval else None,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
