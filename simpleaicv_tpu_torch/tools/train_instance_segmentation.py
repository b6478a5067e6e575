"""Instance-segmentation training (counterpart of
``tools/train_instance_segmentation.py``; SOLOv2 and YOLACT):

    python -m simpleaicv_tpu_torch.tools.train_instance_segmentation --work-dir <dir>

trains ``<dir>/train_config.py`` on the sum of its ``train_criterion``'s
terms over the model's outputs, the 'annots' and the collater's
'gt_masks'. When the config has a ``test_dataset`` and a ``decoder``, every
epoch ends with the COCO mask evaluation, and the best checkpoint is chosen
by its mAP. It runs on the card, or on the CPU under
``SIMPLEAICV_PLATFORM=cpu``.
"""

from __future__ import annotations

from ..core.platform import device_from_env
from ..core.trainer import Trainer
from ..tasks import instance_segmentation as inst
from .common import load_train_config, parse_work_dir


def main(argv=None):
    """Returns the best key metric (mask mAP x 100, or minus the loss
    without an evaluation)."""
    args = parse_work_dir("instance-segmentation training", argv)
    config = load_train_config(args)

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        return inst.evaluate_coco_segm(model, config.decoder, loader,
                                       config.num_classes, to_device)

    has_eval = (getattr(config, "test_dataset", None) is not None
                and getattr(config, "decoder", None) is not None)
    trainer = Trainer(config, args.work_dir, make_loss_fn=inst.make_loss_fn,
                      evaluate=evaluate if has_eval else None,
                      device=device_from_env())
    return trainer.run()


if __name__ == "__main__":
    main()
