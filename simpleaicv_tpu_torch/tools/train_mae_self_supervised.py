"""MAE pretraining (counterpart of ``tools/train_mae_self_supervised.py``):

    python -m simpleaicv_tpu_torch.tools.train_mae_self_supervised --work-dir <dir>

Loss-only training: no evaluation, and the best checkpoint is the epoch of
the lowest logged loss. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import mae
from .common import load_train_config, parse_work_dir


def main(argv=None):
    args = parse_work_dir("MAE self-supervised training", argv)
    trainer = Trainer(load_train_config(args), args.work_dir,
                      make_loss_fn=mae.make_loss_fn,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
