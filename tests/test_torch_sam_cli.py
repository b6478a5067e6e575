"""The port's SAM CLIs on the CPU: the train CLI trains, resumes and
evaluates a shrunk ``fake_synthetic/tiny_sam`` (the per-dataset IoU of its
two named test sets every epoch) and the test CLI evaluates its ``best``;
both raise without a card unless the CPU is asked for; and the test CLI's
IoU, precision and recall against the JAX package's test CLI on the same
weights and data (within 1e-4), both in f32."""

import importlib.util
import random
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import load_jax_params
from simpleaicv_tpu_torch.tools import test_interactive_segmentation as \
    port_test_cli
from simpleaicv_tpu_torch.tools import train_interactive_segmentation as \
    port_train_cli

from _torch_port import jax_f32, random_params

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "experiments/13.interactive_segmentation_training/" \
    "fake_synthetic/tiny_sam"
TINY = dict(image_size=64, image_encoder_embedding_planes=64,
            image_encoder_block_nums=2, image_encoder_head_nums=2,
            image_encoder_window_size=2,
            image_encoder_global_attn_indexes=(1,),
            prompt_encoder_embedding_planes=64)


def _shrunk_recipe(work_dir, epochs):
    """tiny_sam with 16 train samples, batch 8 (2 batches an epoch) and
    ``epochs`` epochs; its test config restores checkpoints/best."""
    src = (RECIPE / "train_config.py").read_text()
    for old, new in [("FakeSAMSegmentationDataset(\n        32,",
                      "FakeSAMSegmentationDataset(\n        16,"),
                     ("epochs = 2", f"epochs = {epochs}"),
                     ("print_interval = 2", "print_interval = 1")]:
        assert old in src, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    (work_dir / "test_config.py").write_text(
        (RECIPE / "test_config.py").read_text())


def _log(work_dir):
    return (work_dir / "log" / "train.log").read_text()


def test_train_resume_and_test_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _shrunk_recipe(tmp_path, epochs=1)
    argv = ["--work-dir", str(tmp_path)]
    best1 = port_train_cli.main(argv)
    first = _log(tmp_path)
    assert "epoch 1 done" in first and "imgs/s" in first
    evals = re.findall(r"epoch 1 eval: \{'iou/setA': ([0-9.]+), "
                       r"'iou/setB': ([0-9.]+), 'iou': ([0-9.]+)\}", first)
    assert len(evals) == 1
    a, b, both = map(float, evals[0])
    assert both == pytest.approx((a + b) / 2) and best1 == pytest.approx(
        both)
    ckpt = tmp_path / "checkpoints"
    assert (ckpt / "best").is_file() and (ckpt / "latest/1.pt").is_file()

    _shrunk_recipe(tmp_path, epochs=2)
    port_train_cli.main(argv)
    second = _log(tmp_path)[len(first):]
    assert "resumed from epoch 1" in second and "epoch 2 done" in second
    assert "epoch 1 iter" not in second
    assert len(list(ckpt.glob("sam_b-metric*"))) == 1

    metrics = port_test_cli.main(argv)
    assert set(metrics) == {"iou", "precision", "recall"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())


@pytest.mark.parametrize("cli", [port_train_cli, port_test_cli])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _shrunk_recipe(tmp_path, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()


# ------------- the test CLIs, port against JAX, on the same weights -------

CONFIG = '''import numpy as np

from simpleaicv_tpu.core.registry import MODELS
from simpleaicv_tpu.data.interactive_segmentation import (SAMBatchCollater,
                                                          SamResize)


class Discs:
    """One bright disc an image, the same pixels for both packages."""

    def __init__(self, n, hw):
        self.n, self.hw, self.resize = n, hw, SamResize(hw)

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        hw = self.hw
        image = rng.uniform(0, 60, (hw, hw, 3)).astype(np.float32)
        cy, cx = rng.randint(hw // 4, 3 * hw // 4, 2)
        r = rng.randint(hw // 8, hw // 3)
        ys, xs = np.mgrid[:hw, :hw]
        mask = ((ys - cy) ** 2 + (xs - cx) ** 2 <= r * r).astype(np.float32)
        image[mask > 0] = 220.0
        return self.resize({{"image": image, "mask": mask}})


class config:
    network = "sam_b"
    input_image_size = 64
    model = MODELS.create(network, **{tiny!r})
    trained_model_path = {trained!r}
    test_dataset = Discs(6, 64)
    test_collater = SAMBatchCollater(resize=64, use_noise_bbox=False)
    batch_size = 3
    num_workers = 1
'''


def _jax_test_cli(monkeypatch):
    """The JAX package's tools/test_interactive_segmentation.py as a
    module (it imports its sibling ``common``)."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    spec = importlib.util.spec_from_file_location(
        "jax_test_interactive_segmentation",
        REPO / "tools" / "test_interactive_segmentation.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_test_cli_matches_the_jax_test_cli(tmp_path, monkeypatch):
    """Seeded weights in both packages' form; the JAX CLI's collater draws
    its clicks from the global generators, the port's from its own seeded
    0, so the globals are seeded 0."""
    jax_cli = _jax_test_cli(monkeypatch)
    with jax_f32():
        shapes = jax.eval_shape(lambda: JAX_MODELS.create(
            "sam_b", **TINY).init(
                jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32),
                {"prompt_point": np.full((1, 9, 3), -1.0, np.float32),
                 "prompt_box": np.zeros((1, 4), np.float32),
                 "prompt_mask": np.zeros((1, 16, 16, 1), np.float32)},
                (0, 1, 2, 3), False))
    params = random_params(shapes["params"], seed=7)
    port_model = load_jax_params(
        MODELS.create("sam_b", **TINY, dtype=torch.float32), params)
    trained = tmp_path / "weights.pt"
    torch.save({"params": port_model.state_dict(), "metric": 0.0}, trained)
    (tmp_path / "test_config.py").write_text(
        CONFIG.format(tiny=TINY, trained=str(trained)))
    argv = ["--work-dir", str(tmp_path)]

    results = []

    class Recording(jax_cli.sam_task.SegmentationEvalMeter):
        def compute(self):
            results.append(super().compute())
            return results[-1]

    monkeypatch.setattr(jax_cli.sam_task, "SegmentationEvalMeter", Recording)
    monkeypatch.setattr(jax_cli, "restore_trained_params",
                        lambda path, init: params)
    monkeypatch.setattr(sys, "argv", ["test"] + argv)
    random.seed(0)
    np.random.seed(0)
    with jax_f32():
        jax_cli.main()

    load = port_test_cli.load_test_config

    def f32_config(args):
        cfg = load(args)
        cfg.model = MODELS.create("sam_b", **TINY, dtype=torch.float32)
        return cfg

    monkeypatch.setattr(port_test_cli, "load_test_config", f32_config)
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    got = port_test_cli.main(argv)
    want = results[0]
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-4), key
    assert 0 < want["iou"] < 1
