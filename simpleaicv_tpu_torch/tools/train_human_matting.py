"""Human-matting training (counterpart of ``tools/train_human_matting.py``):

    python -m simpleaicv_tpu_torch.tools.train_human_matting --work-dir <dir>

trains ``<dir>/train_config.py`` (a PFAN matting model) on the weighted sum
of its ``criterion_cfg``, with the SAD, MAE and MSE evaluation every epoch
when it has a ``test_dataset``; the best checkpoint has the least SAD. It
runs on the card, or on the CPU under ``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import matting
from .common import load_train_config, parse_work_dir


def main(argv=None):
    """Returns the best key metric (minus the mean SAD)."""
    args = parse_work_dir("human-matting training", argv)
    config = load_train_config(args)
    criterion_cfg = config.criterion_cfg
    trainer = Trainer(
        config, args.work_dir,
        make_loss_fn=lambda _criterion: matting.make_loss_fn(criterion_cfg),
        make_eval_fn=matting.make_eval_fn,
        evaluate=matting.make_evaluate(), device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
