"""The port's DETR-family CLIs on the CPU: the train CLI trains, resumes
and evaluates (the COCO evaluation every epoch) shrunk copies of
``fake_synthetic/resnet18_dino`` and ``fake_synthetic/resnet18_detr``, the
test CLI evaluates their ``best`` and logs MACs and parameters; both raise
without a card unless the CPU is asked for."""

import logging
import re
from pathlib import Path

import pytest

from simpleaicv_tpu_torch.tools import test_detection as test_cli
from simpleaicv_tpu_torch.tools import train_detr_detection as train_cli

REPO = Path(__file__).resolve().parent.parent
RECIPES = REPO / "experiments/3.detection_training/fake_synthetic"
EVAL_SET = '''FakeDetectionDataset(
        num_samples=4, image_hw=64, num_classes=num_classes,
        transform=Compose([
            DetectionResize(resize=input_image_size,
                            resize_type="yolo_style"),
            Normalize(),
        ]))
    decoder = DECODERS.create("{decoder}", num_classes=num_classes)'''


def _shrunk_recipe(work_dir, name, epochs, restore=True):
    """The recipe at 64^2 with 8 train samples (2 batches of 4), a test set
    of 4 and the family's decoder (so every epoch evaluates), and
    ``epochs`` epochs; its test config restores checkpoints/best unless
    ``restore`` is false."""
    decoder = "DINODETRDecoder" if name.endswith("dino") else "DETRDecoder"
    src = (RECIPES / name / "train_config.py").read_text()
    for old, new in [
            ("import MODELS, LOSSES", "import MODELS, LOSSES, DECODERS"),
            ("num_samples=16, image_hw=128", "num_samples=8, image_hw=64"),
            ("input_image_size = 128", "input_image_size = 64"),
            ("test_dataset = None", "test_dataset = "
             + EVAL_SET.format(decoder=decoder)),
            ("test_collater = None", "test_collater = train_collater"),
            ("epochs = 2", f"epochs = {epochs}")]:
        assert old in src, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (RECIPES / name / "test_config.py").read_text()
    old = 'trained_model_path = ""'
    assert old in test
    if restore:
        test = test.replace(
            old, 'trained_model_path = os.path.join(os.path.dirname('
            'os.path.abspath(__file__)), "checkpoints", "best")')
    (work_dir / "test_config.py").write_text(test)


@pytest.mark.parametrize("name", ["resnet18_dino", "resnet18_detr"])
def test_train_resume_and_test_on_the_cpu(tmp_path, monkeypatch, name):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    argv = ["--work-dir", str(tmp_path)]
    log = tmp_path / "log" / "train.log"
    _shrunk_recipe(tmp_path, name, epochs=1)
    best = train_cli.main(argv)
    first = log.read_text()
    assert "epoch 1 done" in first and "imgs/s" in first
    assert re.search(r"epoch 1 eval: \{'IoU=0\.5:0\.95,area=all,maxDets=100,"
                     r"mAP': [-0-9.e]+", first), first
    ckpt = tmp_path / "checkpoints"
    assert (ckpt / "best").is_file() and (ckpt / "latest/1.pt").is_file()

    _shrunk_recipe(tmp_path, name, epochs=2)
    best = train_cli.main(argv)
    second = log.read_text()[len(first):]
    assert "resumed from epoch 1" in second and "epoch 2 eval" in second
    assert "epoch 1 iter" not in second

    stats = test_cli.main(argv)
    assert len(stats) == 11  # 10 COCO statistics and the key metric
    assert stats["key_metric"] == pytest.approx(
        100 * stats["IoU=0.5:0.95,area=all,maxDets=100,mAP"])
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_test_cli_logs_macs_and_parameters(tmp_path, monkeypatch):
    """resnet18_detr without trained weights: the MACs of one 64^2 image
    and its 11.4M parameters."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _shrunk_recipe(tmp_path, "resnet18_detr", epochs=1, restore=False)
    keep = _Keep()
    logger = logging.getLogger("test")
    logger.addHandler(keep)
    try:
        test_cli.main(["--work-dir", str(tmp_path)])
    finally:
        logger.removeHandler(keep)
    assert any(re.fullmatch(r"macs: \S+M, params: 11\.4\d+M", ln)
               for ln in keep.lines), keep.lines


@pytest.mark.parametrize("cli", [train_cli, test_cli])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _shrunk_recipe(tmp_path, "resnet18_dino", epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
