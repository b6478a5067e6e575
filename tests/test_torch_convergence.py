"""The port's per-family learning checks (counterparts of
``tests/test_convergence_families.py``: DeepLabV3+, SAM, FCOS, DDPM and
DBNet),
through the port's ``Trainer`` (SAM's ``SAMTrainer``). They import no JAX,
so the card's machine can collect them; each runs on the card when there
is one, else on the CPU."""

import numpy as np
import pytest
import torch

from simpleaicv_tpu_torch.core.registry import DECODERS, LOSSES, MODELS
from simpleaicv_tpu_torch.core.trainer import Trainer
from simpleaicv_tpu_torch.data.datasets import (LearnableDetectionDataset,
                                                TwoModeImageDataset)
from simpleaicv_tpu_torch.data.detection import (DetectionCollater,
                                                 DetectionResize, Normalize,
                                                 RandomHorizontalFlip)
from simpleaicv_tpu_torch.data.interactive_segmentation import (
    FakeSAMSegmentationDataset, SAMBatchCollater, SamResize)
from simpleaicv_tpu_torch.data.segmentation import (
    FakeSegmentationDataset, SegNormalize, SemanticSegmentationCollater)
from simpleaicv_tpu_torch.data.text_detection import (
    DBNetDecoder, FakeTextDetectionDataset, TextDetectionCollater)
from simpleaicv_tpu_torch.data.transforms import Compose
from simpleaicv_tpu_torch.diffusion import DDPMSampler, DDPMTrainer
from simpleaicv_tpu_torch.tasks import detection as det_task
from simpleaicv_tpu_torch.tasks import diffusion as diff_task
from simpleaicv_tpu_torch.tasks import semantic_segmentation as seg_task
from simpleaicv_tpu_torch.tasks import text_detection as text_task
from simpleaicv_tpu_torch.tools.train_interactive_segmentation import \
    SAMTrainer


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


def sam_learning_config():
    """The recipe of ``test_sam_interactive_segmentation_learns``: the tiny
    SAM (64 wide, 2 blocks, one global layer) at 64^2 on 32 synthetic
    bright-ellipse images, SAMMultiLevelLoss, one prompt kind a batch with
    one refinement click on a point batch, AdamW 3e-4, CosineLR, batch 8,
    40 epochs; the point-prompt IoU over 8 test images."""
    size = 64

    class config:
        network = "sam_b"
        input_image_size = size
        model = MODELS.create(
            network, image_size=size, image_encoder_embedding_planes=64,
            image_encoder_block_nums=2, image_encoder_head_nums=2,
            image_encoder_window_size=2,
            image_encoder_global_attn_indexes=(1,),
            prompt_encoder_embedding_planes=64)
        train_criterion = LOSSES.create("SAMMultiLevelLoss")
        train_dataset = FakeSAMSegmentationDataset(
            32, size, transform=SamResize(size))
        test_dataset = {"setA": FakeSAMSegmentationDataset(
            8, size, transform=SamResize(size))}
        train_collater = SAMBatchCollater(resize=size)
        test_collater = SAMBatchCollater(resize=size, use_noise_bbox=False)
        prompt_probs = {"point": 0.34, "box": 0.33, "mask": 0.33}
        decoder_point_iters = 2
        seed = 0
        batch_size = 8
        num_workers = 2
        accumulation_steps = 1
        optimizer = ("AdamW", {"lr": 3e-4, "global_weight_decay": False,
                               "weight_decay": 1e-3,
                               "no_weight_decay_layer_name_list": []})
        scheduler = ("CosineLR", {"warm_up_epochs": 0})
        epochs = 40
        print_interval = 100
        use_ema_model = False

    return config


@pytest.mark.slow
def test_sam_interactive_segmentation_learns(tmp_path):
    """Tiny SAM through the port's ``SAMTrainer`` (a prompt kind per batch,
    the error-region refinement): the point-prompt IoU rises far above
    chance on bright-ellipse objects."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    best = SAMTrainer(sam_learning_config(), str(tmp_path),
                      device=device).run()
    assert best >= 0.5, f"SAM failed to learn: best IoU {best:.4f}"


def fcos_learning_config():
    """The recipe of ``test_fcos_detection_learns``: resnet18_fcos (64-wide
    pyramid and head) on 64 synthetic 96^2 images of one pure-colour
    rectangle (3 classes), FCOSLoss, AdamW 3e-4, CosineLR to 1e-5, batch
    16, 16 epochs, the FCOS decoder (top 100, 20 detections)."""
    size = 96

    def transform(train):
        return Compose([DetectionResize(resize=size,
                                        resize_type="yolo_style")]
                       + ([RandomHorizontalFlip(prob=0.5)] if train else [])
                       + [Normalize()])

    class config:
        network = "resnet18_fcos"
        num_classes = 3
        input_image_size = size
        model = MODELS.create(network, num_classes=num_classes, planes=64)
        train_criterion = LOSSES.create("FCOSLoss")
        decoder = DECODERS.create("FCOSDecoder", topn=100, max_object_num=20)
        train_dataset = LearnableDetectionDataset(64, size, "train",
                                                  transform=transform(True))
        test_dataset = LearnableDetectionDataset(16, size, "val",
                                                 transform=transform(False))
        train_collater = DetectionCollater(resize=size,
                                           resize_type="yolo_style")
        test_collater = DetectionCollater(resize=size,
                                          resize_type="yolo_style")
        seed = 0
        batch_size = 16
        num_workers = 2
        accumulation_steps = 1
        optimizer = ("AdamW", {"lr": 3e-4, "global_weight_decay": False,
                               "weight_decay": 1e-3,
                               "no_weight_decay_layer_name_list": []})
        scheduler = ("CosineLR", {"warm_up_epochs": 0, "min_lr": 1e-5})
        epochs = 16
        print_interval = 100
        use_ema_model = False

    return config


def train_fcos(work_dir, device):
    """Trains the FCOS learning recipe on ``device``; returns (the best
    mAP x 100, the final model's COCO statistics)."""
    config = fcos_learning_config()

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        return det_task.evaluate_coco(model, config.decoder, loader,
                                      config.num_classes, to_device)

    trainer = Trainer(config, str(work_dir),
                      make_loss_fn=det_task.make_loss_fn, evaluate=evaluate,
                      device=device)
    best = trainer.run()
    final = evaluate(None, trainer.state.model, trainer.test_loader,
                     trainer.to_device)
    return best, final


@pytest.mark.slow
def test_fcos_detection_learns(tmp_path):
    """FCOS: assignment -> loss -> optimizer -> decoder -> COCO mAP rises
    far above chance (near 0) on separable drawn rectangles; the final
    model finds most boxes at IoU 0.5."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    best, final = train_fcos(tmp_path, device)
    assert best >= 30.0, f"FCOS failed to learn: best mAP {best:.2f}"
    assert final["IoU=0.5,area=all,maxDets=100,mAP"] >= 0.5, final


class DiffusionCollater:
    """Images to [-1, 1] and the labels, as the JAX test's collater."""

    def __call__(self, samples):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        return {"image": images / 127.5 - 1.0,
                "label": np.asarray([s["label"] for s in samples], np.int32)}


def ddpm_learning_config():
    """The recipe of ``test_ddpm_learns_two_mode_distribution``: the tiny
    UNet (32 wide, (1, 2), one block a level, attention on the second) on
    64 16^2 images of ``TwoModeImageDataset``, a cosine schedule at T=100
    (the linear one leaves alpha_bar_T at 0.36 there, short of the prior
    the sampler starts from), MSE, AdamW 2e-3, CosineLR, batch 16, 90
    epochs."""
    size = 16

    class config:
        network = "DiffusionUNet"
        input_image_size = size
        model = MODELS.create(network, inplanes=3, planes=32,
                              planes_multi=(1, 2), time_embedding_ratio=4,
                              block_nums=1,
                              use_attention_planes_multi_idx=(1,))
        trainer = DDPMTrainer(beta_schedule_mode="cosine", t=100)
        train_criterion = diff_task.MSELoss()
        train_dataset = TwoModeImageDataset(64, size)
        test_dataset = None
        train_collater = DiffusionCollater()
        test_collater = None
        seed = 0
        batch_size = 16
        num_workers = 2
        accumulation_steps = 1
        optimizer = ("AdamW", {"lr": 2e-3, "global_weight_decay": False,
                               "weight_decay": 0.0,
                               "no_weight_decay_layer_name_list": []})
        scheduler = ("CosineLR", {"warm_up_epochs": 0})
        epochs = 90
        print_interval = 100
        use_ema_model = False

    return config


def train_ddpm(work_dir, device):
    """Trains the DDPM learning recipe on ``device``; returns
    ``generate(generator)``: 64 images from the DDPM sampler (cosine,
    T=100) of the trained UNet."""
    config = ddpm_learning_config()
    trainer = Trainer(config, str(work_dir),
                      make_loss_fn=lambda criterion: diff_task.make_loss_fn(
                          criterion, config.trainer), device=device)
    trainer.run()
    size = config.input_image_size
    return diff_task.make_generate_fn(
        trainer.state.model, DDPMSampler(beta_schedule_mode="cosine", t=100),
        (64, size, size, 3), device=trainer.device)


def two_mode_stats(images):
    """(the share of images whose mean is above 0.3, the share below -0.3,
    each image's distance to the nearer mode, +-0.6)."""
    means = images.mean(dim=(1, 2, 3)).cpu().numpy()
    near = np.minimum(np.abs(means - 0.6), np.abs(means + 0.6))
    return float((means > 0.3).mean()), float((means < -0.3).mean()), near


@pytest.mark.slow
def test_ddpm_learns_two_mode_distribution(tmp_path):
    """The DDPM loop (q-sample -> noise-prediction loss -> optimizer ->
    reverse-process sampler) learns a distribution, not just a loss floor:
    64 samples (the generator seeded with 123) reproduce both modes and
    gather around them, within the JAX test's bounds (an untrained sampler
    gives hi = lo = 0 and a mean distance near 0.6)."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    generate = train_ddpm(tmp_path, device)
    hi, lo, near = two_mode_stats(generate(
        torch.Generator(device).manual_seed(123)))
    assert hi >= 0.15 and lo >= 0.15, (hi, lo)
    assert float(near.mean()) <= 0.33, float(near.mean())


def dbnet_learning_config():
    """The recipe of ``test_dbnet_text_detection_learns``: resnet18_dbnet
    on 32 synthetic 128^2 images of bright rectangles, DBNetLoss, AdamW
    1e-3, CosineLR to 1e-5, batch 8, 20 epochs, the polygon F1 on 8 more
    images with ``DBNetDecoder``."""

    class config:
        network = "resnet18_dbnet"
        input_image_size = 128
        model = MODELS.create(network)
        train_criterion = LOSSES.create("DBNetLoss")
        train_dataset = FakeTextDetectionDataset(num_samples=32,
                                                 image_hw=128)
        test_dataset = FakeTextDetectionDataset(num_samples=8, image_hw=128)
        train_collater = TextDetectionCollater(resize=128)
        test_collater = TextDetectionCollater(resize=128)
        seed = 0
        batch_size = 8
        num_workers = 2
        accumulation_steps = 1
        optimizer = ("AdamW", {"lr": 1e-3, "global_weight_decay": False,
                               "weight_decay": 1e-3,
                               "no_weight_decay_layer_name_list": []})
        scheduler = ("CosineLR", {"warm_up_epochs": 0, "min_lr": 1e-5})
        epochs = 20
        print_interval = 100
        use_ema_model = False

    return config


def train_dbnet(work_dir, device):
    """Trains the DBNet learning recipe on ``device``; returns (the best F1
    x 100, every epoch's F1, the trained model)."""
    config = dbnet_learning_config()
    decoder = DBNetDecoder()
    f1s = []

    def evaluate(eval_step, model, loader, to_device):
        del eval_step
        stats = text_task.evaluate_polygons(model, decoder, loader,
                                            to_device)
        f1s.append(stats["f1"])
        return stats

    trainer = Trainer(config, str(work_dir),
                      make_loss_fn=text_task.make_loss_fn, evaluate=evaluate,
                      device=device)
    return trainer.run(), f1s, trainer.state.model


@pytest.mark.slow
def test_dbnet_learns(tmp_path):
    """DBNet: map losses -> optimizer -> host contour decode -> polygon F1
    rises far above chance (0: an untrained map has no contour) to the JAX
    test's 40."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    best, f1s, _ = train_dbnet(tmp_path, device)
    assert best >= 40.0, f"DBNet failed to learn: F1 by epoch {f1s}"
