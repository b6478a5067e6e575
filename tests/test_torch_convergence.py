"""The port's per-family learning checks (counterparts of
``tests/test_convergence_families.py``), through the port's ``Trainer``.
They import no JAX, so the card's machine can collect them; each runs on
the card when there is one, else on the CPU."""

import pytest
import torch

from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.trainer import Trainer
from simpleaicv_tpu_torch.data.segmentation import (
    FakeSegmentationDataset, SegNormalize, SemanticSegmentationCollater)
from simpleaicv_tpu_torch.data.transforms import Compose
from simpleaicv_tpu_torch.tasks import semantic_segmentation as seg_task


def deeplab_learning_config():
    """The recipe of ``test_deeplab_semantic_segmentation_learns``:
    resnet18_deeplabv3plus on 64 synthetic 64^2 images of coloured
    rectangles, 6 classes, AdamW 1e-3, PolyLR, batch 16, 12 epochs."""

    class config:
        network = "resnet18_deeplabv3plus"
        num_classes = 6
        input_image_size = 64
        ignore_index = 255
        model = MODELS.create(network, num_classes=num_classes)
        train_criterion = LOSSES.create("SegCELoss",
                                        ignore_index=ignore_index)
        train_dataset = FakeSegmentationDataset(
            64, 64, num_classes, transform=Compose([SegNormalize()]))
        test_dataset = FakeSegmentationDataset(
            16, 64, num_classes, transform=Compose([SegNormalize()]))
        train_collater = SemanticSegmentationCollater(resize=64)
        test_collater = SemanticSegmentationCollater(resize=64)
        seed = 0
        batch_size = 16
        num_workers = 2
        accumulation_steps = 1
        optimizer = ("AdamW", {"lr": 1e-3, "global_weight_decay": False,
                               "weight_decay": 1e-3,
                               "no_weight_decay_layer_name_list": []})
        scheduler = ("PolyLR", {"warm_up_epochs": 0, "power": 0.9})
        epochs = 12
        print_interval = 100
        use_ema_model = False

    return config


def train_deeplab(work_dir, device) -> float:
    """Trains the learning recipe on ``device``; returns the best mIoU."""
    config = deeplab_learning_config()
    trainer = Trainer(
        config, str(work_dir), make_loss_fn=seg_task.make_loss_fn,
        make_eval_fn=lambda: seg_task.make_eval_fn(config.num_classes,
                                                   config.ignore_index),
        evaluate=seg_task.make_evaluate(config.num_classes),
        device=device)
    return trainer.run()


@pytest.mark.slow
def test_deeplab_semantic_segmentation_learns(tmp_path):
    """DeepLabV3+: dense CE -> optimizer -> class-area mIoU reaches 60 on
    separable coloured rectangles (chance is near 0)."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    best = train_deeplab(tmp_path, device)
    assert best >= 60.0, f"DeepLab failed to learn: best mIoU {best:.2f}"
