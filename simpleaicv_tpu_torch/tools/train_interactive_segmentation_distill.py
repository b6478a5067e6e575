"""SAM encoder distillation (counterpart of
``tools/train_interactive_segmentation_distill.py``):

    python -m simpleaicv_tpu_torch.tools.train_interactive_segmentation_distill --work-dir <dir>

trains ``<dir>/train_config.py``'s ``SAMDistillEncoderModel`` on its
``train_criterion`` (``SAMDistillMSELoss``) of the student's and the
frozen teacher's image embeddings; with no evaluation the best checkpoint
has the least loss. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from .common import load_train_config, parse_work_dir

__all__ = ["make_loss_fn", "main"]


def make_loss_fn(criterion):
    """``loss_fn(model, batch, generator, train)``: criterion(student,
    teacher) of the two embeddings, no other metric."""

    def loss_fn(model, batch, generator, train):
        del generator
        tea, stu = model(batch["image"], train)
        return criterion(stu, tea), {}

    return loss_fn


def main(argv=None):
    """Returns the best key metric (minus the loss)."""
    args = parse_work_dir("SAM encoder distillation", argv)
    trainer = Trainer(load_train_config(args), args.work_dir,
                      make_loss_fn=make_loss_fn, device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
