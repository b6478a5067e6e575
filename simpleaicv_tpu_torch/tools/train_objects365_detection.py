"""Objects365 pretraining (counterpart of
``tools/train_objects365_detection.py``):

    python -m simpleaicv_tpu_torch.tools.train_objects365_detection --work-dir <dir>

trains ``<dir>/train_config.py`` (the experiments' objects365/
res50_fcos_yoloresize1024 and res50_retinanet_yoloresize1024) as the
dense-detection CLI does, but with no evaluation: the config's
``test_dataset`` is set aside, and the trainer saves ``latest`` every
epoch. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import detection
from .common import load_train_config, parse_work_dir


def main(argv=None):
    args = parse_work_dir("Objects365 detection training", argv)
    config = load_train_config(args)
    config.test_dataset = None  # no per-epoch evaluation; latest each epoch
    return Trainer(config, args.work_dir,
                   make_loss_fn=detection.make_loss_fn,
                   device=device_from_env()).run()


if __name__ == "__main__":
    main()
