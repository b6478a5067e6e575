"""``simpleaicv_tpu_torch.core.config.load_config`` on the repository's own
experiment directories, written for the JAX package: the configs build the
port's objects, a config that names something the port lacks raises naming
it, and loading one leaves the JAX package unimported."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from simpleaicv_tpu_torch.core.config import (MissingCounterpartError,
                                              config_repr, load_config)
from simpleaicv_tpu_torch.data.collater import ClassificationCollater
from simpleaicv_tpu_torch.data.datasets import FakeClassificationDataset
from simpleaicv_tpu_torch.losses import CELoss
from simpleaicv_tpu_torch.models.backbones.resnet import ResNet

REPO = Path(__file__).resolve().parent.parent
EXP = REPO / "experiments/0.classification_training"


@pytest.mark.parametrize("module", ["train_config", "test_config"])
def test_fake_synthetic_resnet18_builds_port_objects(module):
    cfg = load_config(str(EXP / "fake_synthetic/resnet18"), module)
    assert isinstance(cfg.model, ResNet)
    assert isinstance(cfg.model, torch.nn.Module)
    assert cfg.model.fc.weight.shape == (10, 512)
    assert isinstance(cfg.test_dataset, FakeClassificationDataset)
    assert isinstance(cfg.test_collater, ClassificationCollater)
    assert cfg.batch_size == 64 and cfg.network == "resnet18"
    if module == "train_config":
        assert isinstance(cfg.train_criterion, CELoss)
        assert len(cfg.train_dataset) == 512
        assert cfg.optimizer[0] == "SGD" and cfg.use_ema_model is True


def test_each_load_builds_new_objects_and_leaves_sys_path_alone():
    path = str(EXP / "fake_synthetic/resnet18")
    before = list(sys.path)
    assert load_config(path, "test_config").model is not load_config(
        path, "test_config").model
    assert sys.path == before


def test_deviceaug_names_the_missing_counterpart():
    """``data.device_augment`` has its counterpart now: the config builds
    the port's pipeline (it named ``DeviceAugmentPipeline`` as missing
    before)."""
    from simpleaicv_tpu_torch.data import device_augment
    cfg = load_config(str(EXP / "fake_synthetic/resnet18_deviceaug"))
    assert isinstance(cfg.device_augment,
                      device_augment.DeviceAugmentPipeline)
    assert isinstance(cfg.device_augment.augment,
                      device_augment.DeviceAutoAugment)


def test_an_unported_registry_name_raises_missing_counterpart(tmp_path):
    """A config that builds its backbone through the registry by a name
    the port lacks raises naming it. Since the port's registries hold
    every name the JAX package's do, the name is one neither has
    (``darknet19`` and ``vit_moe_tiny_patch16``, which this test named
    before, are ported)."""
    assert isinstance(load_config(str(EXP / "fake_synthetic/vit_moe_tiny"))
                      .model, torch.nn.Module)
    (tmp_path / "train_config.py").write_text(
        "from simpleaicv_tpu.core.registry import BACKBONES\n\n\n"
        "class config:\n"
        "    model = BACKBONES.create('darknet19', num_classes=10)\n")
    assert isinstance(load_config(str(tmp_path)).model, torch.nn.Module)
    (tmp_path / "train_config.py").write_text(
        "from simpleaicv_tpu.core.registry import BACKBONES\n\n\n"
        "class config:\n"
        "    model = BACKBONES.create('darknet_huge', num_classes=10)\n")
    with pytest.raises(MissingCounterpartError,
                       match="backbone 'darknet_huge'"):
        load_config(str(tmp_path))


def test_imagenet_resnet50_names_the_missing_dataset(tmp_path):
    """The ImageNet config loads since the ILSVRC2012 reader is ported (it
    reads nothing when it is built), and so does a COCO config since the
    COCO reader is (its model built on the meta device); a config that
    imports a data module the port still lacks names it."""
    cfg = load_config(str(EXP / "imagenet/resnet50"))
    assert type(cfg.train_dataset).__name__ == "ILSVRC2012Dataset"
    with torch.device("meta"):
        cfg = load_config(str(EXP.parent / "3.detection_training/coco/"
                               "res50_fcos_retinaresize800"))
    assert type(cfg.train_dataset).__name__ == "CocoDetection"
    (tmp_path / "train_config.py").write_text(
        "from simpleaicv_tpu.data.processing.common import "
        "resize_max_side\n")
    with pytest.raises(MissingCounterpartError, match="resize_max_side"):
        load_config(str(tmp_path))


def test_a_failure_inside_a_counterpart_is_not_masked(tmp_path):
    (tmp_path / "train_config.py").write_text(
        "import no_such_module_anywhere\n")
    with pytest.raises(ModuleNotFoundError) as err:
        load_config(str(tmp_path))
    assert not isinstance(err.value, MissingCounterpartError)


def test_plain_module_imports_of_the_jax_package_resolve(tmp_path):
    (tmp_path / "train_config.py").write_text(
        "import simpleaicv_tpu.core.registry\n"
        "from simpleaicv_tpu.data import transforms\n"
        "class config:\n"
        "    registry = simpleaicv_tpu.core.registry\n"
        "    transforms = transforms\n")
    cfg = load_config(str(tmp_path))
    assert cfg.registry.__name__ == "simpleaicv_tpu_torch.core.registry"
    assert cfg.transforms.__name__ == "simpleaicv_tpu_torch.data.transforms"


def test_config_repr():
    cfg = load_config(str(EXP / "fake_synthetic/resnet18"))
    text = config_repr(cfg)
    assert text.startswith("config:\n")
    assert "  batch_size: 64" in text and "  network: 'resnet18'" in text
    assert all(len(row) <= 200 for row in text.splitlines())


def test_loading_leaves_the_jax_package_unimported():
    code = (
        "import sys\n"
        "from simpleaicv_tpu_torch.core.config import load_config\n"
        f"cfg = load_config({str(EXP / 'fake_synthetic/resnet18')!r}, "
        "'test_config')\n"
        "module = type(cfg.model).__module__\n"
        "assert module.startswith('simpleaicv_tpu_torch')\n"
        "bad = [m for m in sys.modules if m == 'simpleaicv_tpu'\n"
        "       or m.startswith('simpleaicv_tpu.') or m == 'jax']\n"
        "print('JAX-PACKAGE-MODULES', bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX-PACKAGE-MODULES []" in proc.stdout
