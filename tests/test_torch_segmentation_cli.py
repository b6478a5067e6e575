"""The port's semantic-segmentation, salient-object-detection, face- and
human-parsing CLIs on the CPU, on shrunk copies of the four
``fake_synthetic`` configs: the train CLI trains an epoch with its
evaluation and writes a best checkpoint, the test CLI restores it (its
BatchNorm statistics included) and returns the same metrics; every CLI
raises without a card unless the CPU is asked for."""

from pathlib import Path

import pytest

from simpleaicv_tpu_torch.tools import (test_face_parsing,
                                        test_human_parsing,
                                        test_salient_object_detection,
                                        test_semantic_segmentation,
                                        train_face_parsing,
                                        train_human_parsing,
                                        train_salient_object_detection,
                                        train_semantic_segmentation)

from _torch_port import one_torch_thread

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"
# config dir -> (train CLI, test CLI, the source's dataset sizes and the
# shrunk ones, replaced in this order, the eval metric's name)
CASES = {
    "4.semantic_segmentation_training/fake_synthetic/resnet18_deeplabv3plus":
        (train_semantic_segmentation, test_semantic_segmentation,
         [("FakeSegmentationDataset(16, 64", "FakeSegmentationDataset(8, 64"),
          ("FakeSegmentationDataset(48", "FakeSegmentationDataset(16")],
         "mean_iou"),
    "6.salient_object_detection_training/fake_synthetic/resnet18_pfan":
        (train_salient_object_detection, test_salient_object_detection,
         [("FakeSegmentationDataset(32", "FakeSegmentationDataset(16"),
          ("FakeSegmentationDataset(8", "FakeSegmentationDataset(4")],
         "miou"),
    "11.face_parsing_training/fake_synthetic/resnet18_pfan_face_parsing":
        (train_face_parsing, test_face_parsing,
         [("16, 64, num_classes", "8, 64, num_classes"),
          ("48, 64, num_classes", "16, 64, num_classes")], "mean_iou"),
    "12.human_parsing_training/fake_synthetic/resnet18_pfan_human_parsing":
        (train_human_parsing, test_human_parsing,
         [("16, 64, num_classes", "8, 64, num_classes"),
          ("48, 64, num_classes", "16, 64, num_classes")], "mean_iou"),
}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _shrunk_recipe(work_dir, rel, restore=True):
    """The config with 16 train and 4 or 8 test samples and 1 epoch; its
    test config restores checkpoints/best unless ``restore`` is false."""
    _, _, shrink, _ = CASES[rel]
    src = (EXPERIMENTS / rel / "train_config.py").read_text()
    for old, new in shrink + [("epochs = 2", "epochs = 1")]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (EXPERIMENTS / rel / "test_config.py").read_text()
    old = 'trained_model_path = ""'
    assert old in test
    if restore:
        test = test.replace(
            old, 'trained_model_path = os.path.join(os.path.dirname('
            'os.path.abspath(__file__)), "checkpoints", "best")')
    (work_dir / "test_config.py").write_text(test)


@pytest.mark.parametrize("rel", sorted(CASES))
def test_train_and_test_on_the_cpu(tmp_path, monkeypatch, rel):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    train_cli, test_cli, _, metric = CASES[rel]
    _shrunk_recipe(tmp_path, rel)
    argv = ["--work-dir", str(tmp_path)]
    best = train_cli.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 2/2" in log and "imgs/s" in log
    assert f"epoch 1 eval: {{'{metric}': " in log
    assert (tmp_path / "checkpoints" / "best").is_file()
    stats = test_cli.main(argv)
    assert stats["key_metric"] == stats[metric]
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


@pytest.mark.parametrize("cli", [
    train_semantic_segmentation, test_semantic_segmentation,
    train_salient_object_detection, test_salient_object_detection,
    train_face_parsing, test_face_parsing, train_human_parsing,
    test_human_parsing], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    name = cli.__name__.rsplit(".", 1)[-1]
    rel = next(r for r, (tr, te, _, _) in CASES.items()
               if name in (tr.__name__.rsplit(".", 1)[-1],
                           te.__name__.rsplit(".", 1)[-1]))
    _shrunk_recipe(tmp_path, rel, restore=False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
