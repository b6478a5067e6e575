"""The port's instance-segmentation and diffusion CLIs on the CPU, on shrunk
copies of ``fake_synthetic/resnet18_solov2``, ``resnet18_yolact`` (8 train
and 4 test images, batches of 4: the train CLI trains an epoch with its
COCO mask evaluation and writes a best checkpoint, the test CLI restores it
and returns the same mAP) and ``tiny_ddpm`` (8 images: the train CLI
writes its epoch's sample grid, the test CLI restores the best and writes
16 PNGs), and every CLI raising without a card unless the CPU is asked
for."""

import re
from pathlib import Path

import numpy as np
import pytest

from simpleaicv_tpu_torch.core.png import read_png
from simpleaicv_tpu_torch.tools import (test_diffusion_model,
                                        test_instance_segmentation,
                                        train_diffusion_model,
                                        train_instance_segmentation)

from _torch_port import one_torch_thread

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"
INSTANCE = "5.instance_segmentation_training/fake_synthetic/"
DDPM = "20.diffusion_model_training/fake_synthetic/tiny_ddpm"
# config dir -> (train CLI, test CLI, the source's lines and the shrunk ones)
CASES = {
    INSTANCE + "resnet18_solov2":
        (train_instance_segmentation, test_instance_segmentation,
         [("num_samples=16", "num_samples=8"),
          ("batch_size = 8", "batch_size = 4")]),
    INSTANCE + "resnet18_yolact":
        (train_instance_segmentation, test_instance_segmentation,
         [("num_samples=16", "num_samples=8"),
          ("batch_size = 8", "batch_size = 4")]),
    DDPM: (train_diffusion_model, test_diffusion_model,
           [("num_samples=16", "num_samples=8")]),
}
MAP = "IoU=0.5:0.95,area=all,maxDets=100,mAP"
BEST = ('trained_model_path = os.path.join(os.path.dirname('
        'os.path.abspath(__file__)), "checkpoints", "best")')


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _shrunk_recipe(work_dir, rel, restore=True):
    src = (EXPERIMENTS / rel / "train_config.py").read_text()
    for old, new in CASES[rel][2]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (EXPERIMENTS / rel / "test_config.py").read_text()
    # SOLOv2's test config stands alone, restoring its own directory's
    # best; the others derive from the train config
    own = 'trained_model_path = os.path.join(_DIR, "checkpoints", "best")'
    if own in test:
        if not restore:
            test = test.replace(own, 'trained_model_path = ""')
    else:
        assert 'trained_model_path = ""' in test
        if restore:
            test = test.replace('trained_model_path = ""', BEST)
    (work_dir / "test_config.py").write_text(test)


@pytest.mark.parametrize("rel", [r for r in sorted(CASES) if r != DDPM])
def test_instance_segmentation_on_the_cpu(tmp_path, monkeypatch, rel):
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


def test_diffusion_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _shrunk_recipe(tmp_path, DDPM)
    argv = ["--work-dir", str(tmp_path)]
    best = train_diffusion_model.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 eval: {'sample_grids_saved': 1.0}" in log
    assert np.isfinite(best) and best < 0  # minus the loss
    grid = read_png(str(tmp_path / "samples" / "grid_0001.png"))
    assert grid.shape == (32, 32, 3)  # 2 x 2 images of 16^2
    stats = test_diffusion_model.main(argv)
    assert stats == {"generated": 16}
    images = [read_png(str(tmp_path / "generated" / f"{i}.png"))
              for i in range(16)]
    assert all(im.shape == (16, 16, 3) for im in images)
    assert len({im.tobytes() for im in images}) == 16


@pytest.mark.parametrize("rel,which", [(r, w) for r in sorted(CASES)
                                       for w in (0, 1)])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, rel, which):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _shrunk_recipe(tmp_path, rel, restore=False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        CASES[rel][which].main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
