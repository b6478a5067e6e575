"""The port's dense-detection and face-detection CLIs on the CPU, on shrunk
copies of ``fake_synthetic/resnet18_fcos`` and
``fake_synthetic/resnet18_retinaface`` (the train CLI trains an epoch with
its COCO evaluation and writes a best checkpoint, the test CLI restores it
and returns the same mAP), Sapiens through the face-parsing CLIs on the
CelebAMask-HQ recipe with synthetic data and a tiny backbone, and every
new CLI raising without a card unless the CPU is asked for."""

import re
from pathlib import Path

import pytest

from simpleaicv_tpu_torch.tools import (test_detection, test_face_detection,
                                        test_face_parsing, train_detection,
                                        train_face_detection,
                                        train_face_parsing)

from _torch_port import one_torch_thread, register_tiny_sapiens

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"
# config dir -> (train CLI, test CLI, the source's lines and the shrunk
# ones: 8 train and 4 test samples, batches of 4, 1 epoch)
CASES = {
    "3.detection_training/fake_synthetic/resnet18_fcos":
        (train_detection, test_detection,
         [("num_samples=64", "num_samples=8"),
          ("num_samples=16", "num_samples=4")]),
    "10.face_detection_training/fake_synthetic/resnet18_retinaface":
        (train_face_detection, test_face_detection,
         [("num_samples=32", "num_samples=8"),
          ("num_samples=16", "num_samples=4")]),
}
SHRINK = [("batch_size = 8", "batch_size = 4"), ("epochs = 2", "epochs = 1")]
MAP = "IoU=0.5:0.95,area=all,maxDets=100,mAP"

# the CelebAMask-HQ/sapiens_0_3b_face_parsing recipe's fields (19 classes,
# SegCELoss + softmax SegIoULoss 1:1 with 255 ignored, the flip, AdamW
# 1e-4 / 1e-3, CosineLR to 1e-6 after a 1-epoch warm-up) with
# FakeSegmentationDataset in place of FaceParsingDataset, cut to the
# tiny backbone at 64^2, 8 train and 4 test images, 1 epoch
SAPIENS_TRAIN_CONFIG = '''
from simpleaicv_tpu.core.registry import LOSSES, MODELS
from simpleaicv_tpu.data.segmentation import (FakeSegmentationDataset,
                                              SegNormalize,
                                              SegRandomHorizontalFlip,
                                              SegResize,
                                              SemanticSegmentationCollater)
from simpleaicv_tpu.data.transforms import Compose


class config:
    network = "sapiens_0_3b_face_parsing"
    num_classes = 19
    input_image_size = 64
    ignore_index = 255

    model = MODELS.create(network, num_classes=num_classes,
                          image_size=input_image_size,
                          backbone_type="tiny_sapiens",
                          deconv_planes=(32, 16, 16, 8),
                          conv_planes=(8, 8, 8, 8))
    train_criterion = LOSSES.create("SegCombinedLoss", loss_cfg=[
        ("SegCELoss", 1.0, {"ignore_index": ignore_index}),
        ("SegIoULoss", 1.0, {"logit_type": "softmax",
                             "ignore_index": ignore_index}),
    ])
    train_dataset = FakeSegmentationDataset(
        8, 80, num_classes, transform=Compose([
            SegResize(resize=input_image_size),
            SegRandomHorizontalFlip(prob=0.5), SegNormalize()]))
    test_dataset = FakeSegmentationDataset(
        4, 80, num_classes, transform=Compose([
            SegResize(resize=input_image_size), SegNormalize()]))
    train_collater = SemanticSegmentationCollater(resize=input_image_size)
    test_collater = SemanticSegmentationCollater(resize=input_image_size)

    seed = 0
    batch_size = 4
    num_workers = 2
    accumulation_steps = 1
    optimizer = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-3,
                           "no_weight_decay_layer_name_list": []})
    scheduler = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
    epochs = 1
    print_interval = 1
    use_ema_model = False
'''
SAPIENS_TEST_CONFIG = '''import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from train_config import config as _train  # noqa: E402


class config:
    network = _train.network
    input_image_size = _train.input_image_size
    num_classes = _train.num_classes
    model = _train.model
    trained_model_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "checkpoints", "best")
    test_dataset = _train.test_dataset
    test_collater = _train.test_collater
    seed = _train.seed
    batch_size = _train.batch_size
    num_workers = _train.num_workers
'''


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    register_tiny_sapiens()
    with one_torch_thread():
        yield


def _shrunk_recipe(work_dir, rel, restore=True):
    """The configs shrunk as ``CASES`` says; the test config restores
    checkpoints/best unless ``restore`` is false."""
    src = (EXPERIMENTS / rel / "train_config.py").read_text()
    for old, new in CASES[rel][2] + SHRINK:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (EXPERIMENTS / rel / "test_config.py").read_text()
    # FCOS's test config stands alone: its own test set, restoring its own
    # directory's best; RetinaFace's derives from the train config
    best = ('trained_model_path = os.path.join(os.path.dirname('
            'os.path.abspath(__file__)), "checkpoints", "best")')
    own = 'trained_model_path = os.path.join(_DIR, "checkpoints", "best")'
    for old, new in CASES[rel][2] + SHRINK:
        test = test.replace(old, new)
    if own in test:
        if not restore:
            test = test.replace(own, 'trained_model_path = ""')
    else:
        assert 'trained_model_path = ""' in test
        if restore:
            test = test.replace('trained_model_path = ""', best)
    (work_dir / "test_config.py").write_text(test)


@pytest.mark.parametrize("rel", sorted(CASES))
def test_train_and_test_on_the_cpu(tmp_path, monkeypatch, rel):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    train_cli, test_cli, _ = CASES[rel]
    _shrunk_recipe(tmp_path, rel)
    argv = ["--work-dir", str(tmp_path)]
    best = train_cli.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 2/2" in log and "imgs/s" in log
    assert re.search(r"epoch 1 eval: \{'" + re.escape(MAP)
                     + r"': [-0-9.e]+", log), log
    assert (tmp_path / "checkpoints" / "best").is_file()
    stats = test_cli.main(argv)
    assert len(stats) == 11  # 10 COCO statistics and the key metric
    assert stats["key_metric"] == pytest.approx(100 * stats[MAP])
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


def _sapiens_recipe(work_dir):
    (work_dir / "train_config.py").write_text(SAPIENS_TRAIN_CONFIG)
    (work_dir / "test_config.py").write_text(SAPIENS_TEST_CONFIG)


def test_sapiens_face_parsing_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _sapiens_recipe(tmp_path)
    argv = ["--work-dir", str(tmp_path)]
    best = train_face_parsing.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 2/2" in log
    assert "epoch 1 eval: {'mean_iou': " in log
    stats = test_face_parsing.main(argv)
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


@pytest.mark.parametrize("cli", [train_detection, test_detection,
                                 train_face_detection, test_face_detection],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    name = cli.__name__.rsplit(".", 1)[-1]
    rel = next(r for r, (tr, te, _) in CASES.items()
               if name in (tr.__name__.rsplit(".", 1)[-1],
                           te.__name__.rsplit(".", 1)[-1]))
    _shrunk_recipe(tmp_path, rel, restore=False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
