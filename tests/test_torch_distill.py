"""The port's knowledge distillation (``simpleaicv_tpu_torch/models/
distillmodel.py``, ``losses/distillation.py``, ``tasks/distillation.py``,
``tools/train_distill_classification.py``) against the JAX package's on the
CPU, in f32, on the same weights:

* ``KDLoss``, ``DMLLoss`` and ``L2Loss`` to 1e-6, with logits that hit the
  probability clamp;
* ``KDModel``'s teacher and student logits to 1e-4 of their scale and the
  student's batch statistics to 1e-5, the teacher without any gradient and
  with its running statistics unmoved under ``model.train()``;
* one engine step (CE + KD, SGD with weight decay) against the JAX step:
  every leaf's change as ``_torch_port.assert_updates_agree`` bounds it,
  the teacher's included (weight decay on a zero gradient);
* ``train_distill_classification.main(argv)`` on
  ``fake_synthetic/resnet18_kd``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.losses import distillation as jax_losses
from simpleaicv_tpu.tasks import distillation as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.losses import distillation as port_losses
from simpleaicv_tpu_torch.models.distillmodel import KDModel
from simpleaicv_tpu_torch.tasks import distillation as port_task
from simpleaicv_tpu_torch.tools import train_distill_classification

from _torch_port import (assert_updates_agree, flatten_tree, jax_f32,
                         one_torch_thread, random_batch_stats, random_params)

REPO = Path(__file__).resolve().parent.parent
RECIPE = (REPO / "experiments/1.distillation_training/fake_synthetic/"
          "resnet18_kd")
LOSS_LIST = [{"loss_name": "CELoss", "loss_ratio": 1.0},
             {"loss_name": "KDLoss", "loss_ratio": 1.0, "T": 1.0}]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _logits(seed, n=6, k=10, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(n, k)).astype(
        np.float32)


@pytest.mark.parametrize("T", [1.0, 4.0])
@pytest.mark.parametrize("scale", [1.0, 20.0])  # 20: probabilities clamp
def test_kd_and_dml_losses(T, scale):
    s, t = _logits(0, scale=scale), _logits(1, scale=scale)
    for name in ("KDLoss", "DMLLoss"):
        want = getattr(jax_losses, name)(T)(jnp.asarray(s), jnp.asarray(t))
        got = getattr(port_losses, name)(T)(torch.from_numpy(s),
                                            torch.from_numpy(t))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_l2_loss():
    a = np.random.RandomState(2).randn(4, 8, 8, 16).astype(np.float32)
    b = np.random.RandomState(3).randn(4, 8, 8, 16).astype(np.float32)
    want = jax_losses.L2Loss()(jnp.asarray(a), jnp.asarray(b))
    got = port_losses.L2Loss()(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """resnet18 teacher and student at 32^2, 10 classes: the JAX model and
    its seeded (params, batch_stats)."""
    with jax_f32():
        jm = JAX_MODELS.create("KDTeacherStudent", teacher_type="resnet18",
                               student_type="resnet18", num_classes=10)
        shapes = jax.eval_shape(lambda r, x: jm.init(r, x, False),
                                jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))
    return (jm, random_params(shapes["params"], 0),
            random_batch_stats(shapes["batch_stats"], 1))


def _port_model(params, stats):
    model = MODELS.create("KDTeacherStudent", teacher_type="resnet18",
                          student_type="resnet18", num_classes=10,
                          dtype=torch.float32)
    return load_jax_params(model, params, batch_stats=stats)


def _images(n=8):
    return np.random.RandomState(4).randn(n, 32, 32, 3).astype(np.float32)


def test_kd_weights_carry_both_ways(pair):
    _, params, stats = pair
    model = _port_model(params, stats)
    paths = jax_paths(model)
    assert paths["teacher.fc.weight"] == "teacher/fc/kernel"
    assert paths["student.layer1.0.conv1.conv.weight"] == \
        "student/layer1_0/conv1/conv/kernel"
    for got, want in ((export_jax_params(model), params),
                      (export_jax_batch_stats(model), stats)):
        got = flatten_tree(got)
        for path, w in flatten_tree(want).items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_kd_model_forward_gradients_and_frozen_teacher(pair):
    """Train mode: the teacher on its running statistics (they do not
    move), no gradient to it; both heads' logits and the student's new
    statistics against the JAX model's."""
    jm, params, stats = pair
    x = _images()
    with jax_f32():
        (jt, js), new_vars = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x), True,
            mutable=["batch_stats"])
    model = _port_model(params, stats).train()
    assert not model.teacher.training and model.student.training
    teacher_stats = {k: v.clone() for k, v in model.teacher.state_dict()
                     .items() if "running" in k}
    tea, stu = model(torch.from_numpy(x))
    for got, want in ((tea, jt), (stu, js)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
    assert not tea.requires_grad
    port_losses.KDLoss()(stu, tea).backward()
    assert all(p.grad is None for p in model.teacher.parameters())
    assert all(p.grad is not None for p in model.student.parameters())
    for k, v in model.teacher.state_dict().items():
        if "running" in k:
            assert torch.equal(v, teacher_stats[k]), k
    got = flatten_tree(export_jax_batch_stats(model))
    for path, want in flatten_tree(new_vars["batch_stats"]).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=path)


def test_engine_step_matches_jax_with_the_teachers_weight_decay(pair):
    """One CE + KD step, SGD (momentum 0.9, weight decay 1e-2) on both
    engines: every leaf's change agrees (``assert_updates_agree``), the
    teacher's is its weight decay alone, and the student's statistics
    agree to 1e-5."""
    jm, params, stats = pair
    batch = {"image": _images(),
             "label": (np.arange(8) % 10).astype(np.int32)}
    opt = dict(name="SGD", lr=0.05, weight_decay=1e-2, momentum=0.9)
    sched = dict(scheduler="CosineLR", lr=0.05, epochs=2)
    with jax_f32():
        tx, _ = jax_optim.build_optimizer(
            jax_optim.OptimizerConfig(**opt),
            jax_schedule.SchedulerConfig(**sched), 2, params)
        jcfg = jax_engine.EngineConfig()
        jstate = jax_engine.create_train_state(
            jax.tree.map(jnp.asarray, params),
            {"batch_stats": jax.tree.map(jnp.asarray, stats)}, tx, jcfg)
        jstep = jax_engine.make_train_step(
            jax_task.make_loss_fn(jm, jax_task.build_criterion_list(
                LOSS_LIST)), tx, jcfg, donate=False)
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))

    model = _port_model(params, stats)
    popt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**sched), 2, model, device="cpu")
    pcfg = port_engine.EngineConfig()
    state = port_engine.create_train_state(model, popt, pcfg, device="cpu")
    step = port_engine.make_train_step(port_task.make_loss_fn(
        port_task.build_criterion_list(LOSS_LIST)), pcfg)
    state, metrics = step(state, {"image": torch.from_numpy(batch["image"]),
                                  "label": torch.from_numpy(batch["label"])})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    for name in ("CELoss", "KDLoss"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), rtol=1e-5)
    got = export_jax_params(model)
    assert_updates_agree(got, jax.tree.map(np.asarray, jstate.params),
                         params, opt)
    # the teacher moved by its weight decay: -lr wd p on a 2-D or 4-D leaf
    # (a momentum step from zero), not at all on a 1-D one
    kernel = "teacher/layer1_0/conv1/conv/kernel"
    start = flatten_tree(params)
    np.testing.assert_allclose(
        flatten_tree(got)[kernel] - start[kernel],
        -0.05 * 1e-2 * start[kernel], rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(flatten_tree(got)["teacher/fc/bias"],
                                  start["teacher/fc/bias"])
    got = flatten_tree(export_jax_batch_stats(model))
    for path, want in flatten_tree(jstate.state_vars["batch_stats"]).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=path)
        if path.startswith("teacher/"):
            np.testing.assert_array_equal(got[path],
                                          flatten_tree(stats)[path])


def test_train_distill_cli_on_fake_synthetic_resnet18_kd(tmp_path,
                                                        monkeypatch):
    """The experiment's config (resnet34 teacher, resnet18 student at
    64^2, 2 epochs) on 32 train and 16 test samples, a quarter of its own:
    the CLI trains, evaluates the student each epoch, writes the best
    checkpoint and returns the best student top-1."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    src = (RECIPE / "train_config.py").read_text()
    for old, new in (("num_samples=128", "num_samples=32"),
                     ("num_samples=64", "num_samples=16")):
        assert old in src
        src = src.replace(old, new)
    (tmp_path / "train_config.py").write_text(src)
    best = train_distill_classification.main(["--work-dir", str(tmp_path)])
    assert (tmp_path / "checkpoints" / "best").exists()
    log = (tmp_path / "log" / "train.log").read_text()
    evals = [ln for ln in log.splitlines() if " eval: {" in ln]
    assert len(evals) == 2 and "'acc5'" in evals[0]
    assert 0.0 <= best <= 100.0
    assert isinstance(MODELS.create("KDTeacherStudent",
                                    teacher_type="resnet34",
                                    student_type="resnet18",
                                    num_classes=10), KDModel)


def test_distill_cli_raises_without_a_card(tmp_path, monkeypatch):
    """Unless the CPU is asked for, the CLI runs on the card, and raises
    where there is none."""
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    (tmp_path / "train_config.py").write_text(
        (RECIPE / "train_config.py").read_text())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_distill_classification.main(["--work-dir", str(tmp_path)])
