"""The port's ``Trainer`` (``simpleaicv_tpu_torch/core/trainer.py``) and
classification CLIs, on the CPU:

* parity: one epoch of the tiny config (resnet18 at 32^2, 64 samples, batch
  16, SGD) through the JAX ``Trainer`` and the port's, in f32, from the same
  initial weights (the JAX init carried across with ``core/weights.py``
  through ``trained_model_path``): parameters, BatchNorm statistics and the
  evaluation's acc1 and acc5;
* resume: 2 epochs, then 1 more resumed, equals 3 epochs straight, exactly;
* the CLIs in a subprocess under ``SIMPLEAICV_PLATFORM=cpu`` on a shrunk
  copy of ``experiments/0.classification_training/fake_synthetic/resnet18``;
* the device: no card, no run, unless the CPU is asked for.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.core.trainer import Trainer as JaxTrainer
from simpleaicv_tpu.data.collater import \
    ClassificationCollater as JaxCollater
from simpleaicv_tpu.data.datasets import \
    LearnableClassificationDataset as JaxLearnable
from simpleaicv_tpu.losses import CELoss as JaxCELoss
from simpleaicv_tpu.tasks import classification as jax_task
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.trainer import Trainer
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data.collater import ClassificationCollater
from simpleaicv_tpu_torch.data.datasets import (FakeClassificationDataset,
                                                LearnableClassificationDataset)
from simpleaicv_tpu_torch.losses import CELoss
from simpleaicv_tpu_torch.tasks import classification as port_task

from _torch_port import (TinyClassifier, flatten_tree, jax_f32,
                         one_torch_thread)

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "experiments/0.classification_training/fake_synthetic/resnet18"


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _recipe(**fields):
    """The shared fields of the tiny config; the datasets, model and
    collaters are each side's own."""
    base = dict(network="resnet18", num_classes=4, input_image_size=32,
                seed=0, batch_size=16, num_workers=2, accumulation_steps=1,
                optimizer=("SGD", {"lr": 0.01, "momentum": 0.9,
                                   "global_weight_decay": False,
                                   "weight_decay": 1e-4,
                                   "no_weight_decay_layer_name_list": []}),
                scheduler=("CosineLR", {"warm_up_epochs": 0,
                                        "min_lr": 1e-5}),
                epochs=1, print_interval=2, use_ema_model=False)
    base.update(fields)
    return type("config", (), base)


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The JAX Trainer after one epoch: (its initial params and
    batch_stats as numpy trees, final params and batch_stats, acc1, acc5)."""
    work = tmp_path_factory.mktemp("jax_trainer")
    with jax_f32():
        cfg = _recipe(
            model=JAX_BACKBONES.create("resnet18", num_classes=4),
            train_criterion=JaxCELoss(), test_criterion=JaxCELoss(),
            train_dataset=JaxLearnable(num_samples=64, image_hw=32),
            test_dataset=JaxLearnable(num_samples=32, image_hw=32,
                                      set_name="val"),
            train_collater=JaxCollater(), test_collater=JaxCollater())
        trainer = JaxTrainer(cfg, str(work),
                             make_loss_fn=jax_task.make_loss_fn,
                             make_eval_fn=jax_task.make_eval_fn,
                             evaluate=jax_task.evaluate)
        # copies: the step donates the state's buffers
        as_np = lambda t: jax.tree.map(np.array, t)  # noqa: E731
        init = (as_np(trainer.state.params),
                as_np(trainer.state.state_vars["batch_stats"]))
        trainer.run()
        metrics = jax_task.evaluate(trainer.eval_step, trainer.eval_params(),
                                    trainer.state.state_vars,
                                    trainer.test_loader, trainer.shard)
    return (init, as_np(trainer.state.params),
            as_np(trainer.state.state_vars["batch_stats"]),
            metrics["acc1"], metrics["acc5"])


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """The port's CPU steps without oneDNN. oneDNN's f32 convolution
    backward parts from an f64 reference of the same ResNet-18 by up to 8%
    of a weight gradient's largest value at these shapes (layers 3 and 4 at
    2x2 and 1x1), where PyTorch's native kernels and the JAX package agree
    with it to 1e-6."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _port_config(**fields):
    fields.setdefault("model", BACKBONES.create("resnet18", num_classes=4,
                                                dtype=torch.float32))
    return _recipe(
        train_criterion=CELoss(), test_criterion=CELoss(),
        train_dataset=LearnableClassificationDataset(num_samples=64,
                                                     image_hw=32),
        test_dataset=LearnableClassificationDataset(num_samples=32,
                                                    image_hw=32,
                                                    set_name="val"),
        train_collater=ClassificationCollater(),
        test_collater=ClassificationCollater(), **fields)


def _port_trainer(cfg, work_dir):
    return Trainer(cfg, str(work_dir), make_loss_fn=port_task.make_loss_fn,
                   make_eval_fn=port_task.make_eval_fn,
                   evaluate=port_task.evaluate, device="cpu")


def test_trainer_tracks_the_jax_trainer_over_an_epoch(jax_trained, tmp_path):
    """The epoch's change of every parameter and running statistic within
    10% in L2 of the JAX change and at a cosine above 0.995, the change of
    all of them together within 1%; the evaluation's acc1 and acc5 equal.

    A single step's gradients agree to 1e-4 of their scale, but a ReLU
    whose input lies within f32 rounding of 0 (the two sides sum the
    convolutions in another order) switches its gradient on one side and
    not the other, and four SGD steps carry that on: measured, the worst
    tensors (BatchNorm biases, whose change is all update) 5.3% apart at a
    cosine of 0.9986, all together 0.16%."""
    (params0, stats0), params, stats, acc1, acc5 = jax_trained
    init = load_jax_params(
        BACKBONES.create("resnet18", num_classes=4, dtype=torch.float32),
        params0, batch_stats=stats0)
    ckpt = tmp_path / "init.pt"
    torch.save({"params": init.state_dict(), "metric": 0.0}, ckpt)
    trainer = _port_trainer(_port_config(trained_model_path=str(ckpt)),
                            tmp_path / "port")
    assert trainer.steps_per_epoch == 4
    best = trainer.run()
    metrics = port_task.evaluate(trainer.eval_step, trainer.state.model,
                                 trainer.test_loader, trainer.to_device)
    assert trainer.state.optimizer.step_count == 4
    got = {**flatten_tree(export_jax_params(trainer.state.model)),
           **{f"stats/{k}": v for k, v in flatten_tree(
               export_jax_batch_stats(trainer.state.model)).items()}}
    want = {**flatten_tree(params),
            **{f"stats/{k}": v for k, v in flatten_tree(stats).items()}}
    assert set(got) == set(want)
    start = {**flatten_tree(params0),
             **{f"stats/{k}": v for k, v in flatten_tree(stats0).items()}}
    for path, w in want.items():
        du, dw = (got[path] - start[path]).ravel(), (w - start[path]).ravel()
        rel = np.linalg.norm(du - dw) / np.linalg.norm(dw)
        cos = du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))
        assert rel <= 0.1 and cos >= 0.995, (path, rel, cos)
    du = np.concatenate([(got[p] - start[p]).ravel() for p in want])
    dw = np.concatenate([(want[p] - start[p]).ravel() for p in want])
    assert np.linalg.norm(du - dw) <= 1e-2 * np.linalg.norm(dw)
    assert (metrics["acc1"], metrics["acc5"]) == (acc1, acc5)
    assert best == acc1


def _state_tensors(trainer):
    state = trainer.state
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for kind, tensors in state.optimizer.state_dict()["moments"].items():
        out.update({f"{kind}/{k}": v for k, v in tensors.items()})
    out.update({f"ema/{k}": v for k, v in state.ema_params.items()})
    return out


def test_resume_equals_an_unbroken_run(tmp_path):
    """2 epochs, then the same directory with 3: the second run restores
    the parameters, buffers, moments, step counts and EMA of epoch 2 and
    trains epoch 3 alone, to the same bits as 3 epochs straight. The
    schedule (MultiStepLR) does not depend on the epoch count; the model is
    a tiny classifier (the bookkeeping, not ResNet, is under test)."""
    fields = dict(scheduler=("MultiStepLR", {"milestones": [2],
                                             "gamma": 0.1}),
                  use_ema_model=True, ema_model_decay=0.9)
    small = dict(train_dataset=FakeClassificationDataset(
        num_samples=32, image_hw=32, num_classes=4), batch_size=8)

    def run(work_dir, epochs):
        cfg = _port_config(epochs=epochs, model=TinyClassifier(), **fields)
        for key, val in small.items():
            setattr(cfg, key, val)
        trainer = _port_trainer(cfg, work_dir)
        trainer.run()
        return trainer

    run(tmp_path / "broken", 2)
    resumed = run(tmp_path / "broken", 3)
    straight = run(tmp_path / "straight", 3)
    assert resumed.start_epoch == 3
    assert resumed.state.step == straight.state.step == 12
    assert resumed.state.optimizer.step_count == 12
    got, want = _state_tensors(resumed), _state_tensors(straight)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert resumed.best_metric == straight.best_metric
    assert sorted(os.listdir(tmp_path / "broken/checkpoints/latest")) == [
        "2.pt", "3.pt"]


def test_trainer_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    cfg = _port_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, str(tmp_path), make_loss_fn=port_task.make_loss_fn)


def test_trainer_refuses_device_augment(tmp_path):
    """The Trainer no longer refuses a config's ``device_augment``: it is
    the engine step's ``augment_fn``, called with the card's (here the
    CPU's) batch and the step's generator before the forward."""
    calls = []

    def augment(batch, generator):
        calls.append((batch["image"].dtype, type(generator)))
        return batch

    trainer = _port_trainer(_port_config(device_augment=augment), tmp_path)
    batch = next(iter(trainer._device_prefetch(trainer.train_loader)))
    trainer.train_batch(batch)
    assert calls == [(torch.float32, torch.Generator)]


def _shrunk_recipe(work_dir, epochs):
    """fake_synthetic/resnet18 at 32^2, 32 train and 16 test samples, batch
    8, ``epochs`` epochs; its test config restores checkpoints/best."""
    src = (RECIPE / "train_config.py").read_text()
    for old, new in [("num_samples=512, image_hw=64", "num_samples=32, "
                      "image_hw=32"),
                     ("num_samples=128, image_hw=64", "num_samples=16, "
                      "image_hw=32"),
                     ("input_image_size = 64", "input_image_size = 32"),
                     ("batch_size = 64", "batch_size = 8"),
                     ("epochs = 5", f"epochs = {epochs}")]:
        assert old in src
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (RECIPE / "test_config.py").read_text()
    old = 'trained_model_path = ""'
    assert old in test
    (work_dir / "test_config.py").write_text(test.replace(
        old, 'trained_model_path = os.path.join(os.path.dirname('
        'os.path.abspath(__file__)), "checkpoints", "best")'))


def _cli(tool, work_dir, **env):
    proc = subprocess.run(
        [sys.executable, "-m", f"simpleaicv_tpu_torch.tools.{tool}",
         "--work-dir", str(work_dir)], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO), **env})
    return proc.returncode, proc.stderr


def test_clis_train_resume_and_test_on_the_cpu(tmp_path):
    _shrunk_recipe(tmp_path, epochs=1)
    rc, log = _cli("train_classification", tmp_path,
                   SIMPLEAICV_PLATFORM="cpu")
    assert rc == 0, log
    assert "epoch 1 done" in log and "imgs/s" in log
    ckpt = tmp_path / "checkpoints"
    assert (ckpt / "best").is_file() and (ckpt / "latest/1.pt").is_file()
    assert (tmp_path / "log/train.log").is_file()
    _shrunk_recipe(tmp_path, epochs=2)
    rc, log = _cli("train_classification", tmp_path,
                   SIMPLEAICV_PLATFORM="cpu")
    assert rc == 0, log
    assert "resumed from epoch 1" in log and "epoch 1 iter" not in log
    best = max(float(v) for v in re.findall(r"'acc1': ([0-9.]+)", log)
               + [float(re.search(r"best ([0-9.]+)", log).group(1))])
    named = list(ckpt.glob("resnet18-metric*"))
    assert len(named) == 1 and named[0].is_symlink()
    assert named[0].name == f"resnet18-metric{best:.3f}"
    rc, log = _cli("test_classification", tmp_path,
                   SIMPLEAICV_PLATFORM="cpu")
    assert rc == 0, log
    assert re.search(r"macs: \S+M, params: 11\.\d+M", log), log
    top1 = float(re.search(r"top1: ([0-9.]+)%", log).group(1))
    assert top1 == pytest.approx(best, abs=1e-3)


def test_cli_raises_without_a_card(tmp_path, monkeypatch):
    _shrunk_recipe(tmp_path, epochs=1)
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    rc, log = _cli("train_classification", tmp_path)
    assert rc != 0
    assert "no CUDA device is available" in log
    assert not (tmp_path / "checkpoints").exists()
