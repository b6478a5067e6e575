"""The port's checkpoints (``simpleaicv_tpu_torch/core/checkpoint.py``) and
the optimizer's ``state_dict`` / ``load_state_dict``, on the CPU: a latest
round trip of the whole training state, a best round trip and its named
link, ``load_state_dict_partial`` against the JAX one (the name-and-shape
filter and the bicubic position-embedding resize), and a resumed SGD and
AdamW trajectory against an unbroken one.

Tolerances: the position-embedding resize within 5e-5 of the JAX one
(OpenCV's and PyTorch's bicubic weights at other precisions, on values of
unit scale); everything else exact.
"""

import io
import os

import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.checkpoint import \
    load_state_dict_partial as jax_partial
from simpleaicv_tpu_torch.core.checkpoint import (CheckpointManager,
                                                  load_checkpoint_tensors,
                                                  load_state_dict_partial)
from simpleaicv_tpu_torch.core.engine import (EngineConfig,
                                              create_train_state,
                                              make_train_step)
from simpleaicv_tpu_torch.core.optim import OptimizerConfig, build_optimizer
from simpleaicv_tpu_torch.core.schedule import SchedulerConfig
from simpleaicv_tpu_torch.losses import CELoss
from simpleaicv_tpu_torch.models.common import init_params
from simpleaicv_tpu_torch.tasks import classification as port_task

from _torch_port import TinyClassifier

OPTIMIZERS = {
    "SGD": OptimizerConfig(name="SGD", lr=0.05, momentum=0.9,
                           weight_decay=1e-4),
    "AdamW": OptimizerConfig(name="AdamW", lr=1e-3, weight_decay=0.05),
}
SCHED = SchedulerConfig("CosineLR", lr=0.05, epochs=4, warm_up_epochs=1)


def _state(opt="SGD", use_ema=True, seed=0):
    model = init_params(TinyClassifier(), torch.Generator().manual_seed(seed))
    optimizer, _ = build_optimizer(OPTIMIZERS[opt], SCHED, 2, model,
                                   device="cpu")
    cfg = EngineConfig(use_ema=use_ema, ema_decay=0.9)
    return (create_train_state(model, optimizer, cfg, device="cpu"),
            make_train_step(port_task.make_loss_fn(CELoss()), cfg))


def _batch(i):
    g = torch.Generator().manual_seed(100 + i)
    return {"image": torch.randn(4, 16, 16, 3, generator=g),
            "label": torch.randint(0, 4, (4,), generator=g)}


def _tensors(state):
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for kind, moments in state.optimizer.state_dict()["moments"].items():
        out.update({f"{kind}/{k}": v for k, v in moments.items()})
    if state.ema_params is not None:
        out.update({f"ema/{k}": v for k, v in state.ema_params.items()})
    return out


def _assert_same(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key
    assert a.step == b.step
    assert a.optimizer.step_count == b.optimizer.step_count


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_latest_round_trip_of_the_whole_state(tmp_path, opt):
    state, step = _state(opt)
    for i in range(3):
        state, _ = step(state, _batch(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_latest(1, state, {"best_metric": 12.5, "time": 3.0})
    fresh, _ = _state(opt, seed=1)
    assert mgr.restore_latest(fresh) == (1, {"best_metric": 12.5,
                                             "time": 3.0})
    _assert_same(fresh, state)
    assert fresh.optimizer.step_count == 3 and fresh.step == 3


def test_latest_keeps_the_newest_two(tmp_path):
    state, step = _state()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(state) is None
    for epoch in (1, 2, 3):
        state, _ = step(state, _batch(epoch))
        mgr.save_latest(epoch, state)
    assert sorted(os.listdir(tmp_path / "latest")) == ["2.pt", "3.pt"]
    fresh, _ = _state(seed=1)
    assert mgr.restore_latest(fresh)[0] == 3
    _assert_same(fresh, state)
    assert not [f for f in os.listdir(tmp_path / "latest") if "tmp" in f]


def test_restore_refuses_a_state_without_ema(tmp_path):
    state, _ = _state(use_ema=True)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_latest(1, state)
    other, _ = _state(use_ema=False)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore_latest(other)


def test_best_round_trip_and_named_link(tmp_path):
    state, _ = _state()
    tensors = state.model.state_dict()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_best(tensors, 37.25)
    payload = torch.load(tmp_path / "best", weights_only=True)
    params, metric = payload["params"], payload["metric"]
    assert metric == 37.25 and set(params) == set(tensors)
    for key in tensors:
        assert torch.equal(params[key], tensors[key])
    mgr.finalize_best("tiny", 37.25)
    named = tmp_path / "tiny-metric37.250"
    assert named.is_symlink()
    assert os.path.realpath(named) == os.path.realpath(tmp_path / "best")
    mgr.finalize_best("tiny", 37.25)      # again: the link is replaced
    assert named.is_symlink()
    # every checkpoint kind loads as parameters and buffers
    mgr.save_latest(1, state)
    for path in (named, tmp_path / "latest/1.pt"):
        loaded = load_checkpoint_tensors(str(path))
        assert set(loaded) == set(tensors)
    torch.save(tensors, tmp_path / "bare.pt")
    assert set(load_checkpoint_tensors(str(tmp_path / "bare.pt"))) == set(
        tensors)


def _nest(flat):
    tree = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flat(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


@pytest.mark.parametrize("src,dst", [(14, 24), (24, 14), (7, 9)])
def test_partial_load_matches_jax(src, dst):
    """Same name and shape: taken; another shape: the target kept; a name
    the target lacks: dropped; a [1, 1 + N, C] position embedding of
    another token count: resized (the class token kept)."""
    rng = np.random.RandomState(src * dst)
    saved = {"encoder/position_encoding": rng.randn(1, 1 + src * src, 8),
             "encoder/block/kernel": rng.randn(3, 4),
             "encoder/block/bias": rng.randn(5),
             "head/kernel": rng.randn(2, 2)}
    target = {"encoder/position_encoding": np.zeros((1, 1 + dst * dst, 8)),
              "encoder/block/kernel": np.zeros((3, 4)),
              "encoder/block/bias": np.ones(6)}
    saved = {k: v.astype(np.float32) for k, v in saved.items()}
    target = {k: v.astype(np.float32) for k, v in target.items()}
    want, n_want = jax_partial(_nest(saved), _nest(target))
    got, n_got = load_state_dict_partial(
        {k: torch.from_numpy(v) for k, v in saved.items()},
        {k: torch.from_numpy(v) for k, v in target.items()})
    want = _flat(want)
    assert n_got == n_want == 2
    assert set(got) == set(want) == set(target)
    for key in target:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=5e-5,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(
        got["encoder/position_encoding"][:, 0].numpy(),
        saved["encoder/position_encoding"][:, 0])


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_resumed_optimizer_trajectory_equals_an_unbroken_one(opt):
    """Three steps straight, against one step, a save of the model and the
    optimizer's state dict through bytes, a fresh model and optimizer that
    load them, and two more steps: the same bits (moments, step count and
    with it the schedule and Adam's bias correction)."""
    straight, step = _state(opt, use_ema=False)
    for i in range(3):
        straight, _ = step(straight, _batch(i))

    first, step = _state(opt, use_ema=False)
    first, _ = step(first, _batch(0))
    buf = io.BytesIO()
    torch.save({"model": first.model.state_dict(),
                "optimizer": first.optimizer.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    resumed, step = _state(opt, use_ema=False, seed=1)
    resumed.model.load_state_dict(saved["model"])
    resumed.optimizer.load_state_dict(saved["optimizer"])
    resumed.step = 1
    for i in (1, 2):
        resumed, _ = step(resumed, _batch(i))
    _assert_same(resumed, straight)


def test_optimizer_load_checks_what_it_is_given():
    sgd, _ = _state("SGD", use_ema=False)
    adam, _ = _state("AdamW", use_ema=False)
    with pytest.raises(ValueError, match="saved moments"):
        adam.optimizer.load_state_dict(sgd.optimizer.state_dict())
    bad = sgd.optimizer.state_dict()
    name = next(iter(bad["moments"]["trace"]))
    bad["moments"]["trace"][name] = torch.zeros(1)
    with pytest.raises(ValueError, match="saved shape"):
        sgd.optimizer.load_state_dict(bad)
