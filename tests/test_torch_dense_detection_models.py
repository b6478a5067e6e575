"""The port's FCOS, RetinaNet and RetinaFace (ResNet-18) against the JAX
package's, in f32 on the CPU, on seeded weights and BatchNorm statistics
carried across by ``core.weights``: outputs in eval and train mode, the
running statistics after a train-mode forward, parameter gradients, the
weight bridge both ways, and one engine step of each fake_synthetic recipe
(FCOS: FCOSLoss, AdamW, CosineLR; RetinaFace: RetinaFaceLoss, SGD) through
each side's ``make_train_step``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.tasks import detection as jax_det
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data.datasets import FakeDetectionDataset
from simpleaicv_tpu_torch.data.detection import DetectionCollater, Normalize
from simpleaicv_tpu_torch.tasks import detection as port_det

from _torch_port import (assert_updates_agree, flatten_tree, jax_f32,
                         one_torch_thread, random_batch_stats, random_params)

# name -> (kwargs, image side): 64-wide pyramids and heads. FCOS at 136^2,
# where P7 is 2 x 2: at 1 x 1 its GroupNorm (32 groups of 2 channels)
# normalises 2 values, whose gradient is nearly 0 and all rounding
MODEL_CASES = {
    "resnet18_fcos": (dict(num_classes=5, planes=64), 136),
    "resnet18_retinanet": (dict(num_classes=5, planes=64), 96),
    "resnet18_retinaface": (dict(planes=64), 96),
}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """PyTorch's own convolution backward (``tests/test_torch_trainer.py``:
    oneDNN's f32 one parts from an f64 reference by several percent)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _leaves(out):
    return [t for group in out for t in group]


def _variables(name, image, seed=1):
    with jax_f32():
        model = JAX_MODELS.create(name, **MODEL_CASES[name][0])
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), False))
    return model, {"params": random_params(shapes["params"], seed),
                   "batch_stats": random_batch_stats(shapes["batch_stats"],
                                                     seed + 1)}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def case(request):
    """(name, variables, image, output weights, JAX eval outputs, JAX train
    outputs, JAX batch_stats after them, JAX eval-mode gradients of
    sum(outputs * weights))."""
    name = request.param
    side = MODEL_CASES[name][1]
    rng = np.random.RandomState(0)
    image = (rng.rand(2, side, side, 3) + rng.randn(2, 1, 1, 3)).astype(
        np.float32)
    model, variables = _variables(name, image)
    with jax_f32():
        eval_out = jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, image)
        train_out, stats = jax.jit(lambda v, x: model.apply(
            v, x, True, mutable=["batch_stats"]))(variables, image)
        weights = [rng.randn(*o.shape).astype(np.float32)
                   for o in _leaves(eval_out)]

        def loss(params, x):
            out = model.apply({"params": params,
                               "batch_stats": variables["batch_stats"]}, x,
                              False)
            return sum(jnp.sum(o * w) for o, w in zip(_leaves(out), weights))

        grads = jax.jit(jax.grad(loss))(variables["params"], image)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (name, variables, image, weights,
            [np.asarray(o) for o in _leaves(eval_out)],
            [np.asarray(o) for o in _leaves(train_out)],
            as_np(stats["batch_stats"]), as_np(grads))


def _port(name, variables):
    model = MODELS.create(name, dtype=torch.float32, **MODEL_CASES[name][0])
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


def test_eval_mode_matches_jax(case):
    name, variables, image, _, want, _, _, _ = case
    model = _port(name, variables).eval()
    with torch.no_grad():
        got = _leaves(model(torch.from_numpy(image)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * np.abs(w).max(),
                                   rtol=1e-5)


def test_train_mode_outputs_and_running_statistics_match_jax(case):
    """One train-mode forward: every output within 2e-3 of its largest
    value (train-mode BatchNorm divides by batch deviations; the two sides'
    f32 rounding of the batch sums grows with depth, as for ResNet-50 in
    ``tests/test_torch_dinodetr.py``), and every running mean and variance
    within 1e-4."""
    name, variables, image, _, _, want, want_stats, _ = case
    model = _port(name, variables).train()
    with torch.no_grad():
        got = _leaves(model(torch.from_numpy(image)))
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - w).max()
        assert err <= 2e-3 * max(np.abs(w).max(), 1e-6), (err,
                                                          np.abs(w).max())
    got_stats = flatten_tree(export_jax_batch_stats(model))
    want_stats = flatten_tree(want_stats)
    assert set(got_stats) == set(want_stats)
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, atol=1e-4, rtol=1e-4,
                                   err_msg=path)


def test_eval_mode_gradients_match_jax(case):
    """Gradients of sum(outputs * weights) through the running statistics:
    every leaf within 1e-4 of its largest value (or of a thousandth of the
    largest leaf's); the heads are shared across the levels, so each of
    their leaves sums five levels' gradients."""
    name, variables, image, weights, _, _, _, want = case
    model = _port(name, variables)
    out = _leaves(model(torch.from_numpy(image), False))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, weights)
        ).backward()
    got = flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))
    want = flatten_tree(want)
    assert set(got) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), floor), (path, err)


def test_weights_both_ways(case):
    name, variables = case[0], case[1]
    model = _port(name, variables)
    for tree, back in ((variables["params"], export_jax_params(model)),
                       (variables["batch_stats"],
                        export_jax_batch_stats(model))):
        want, got = flatten_tree(tree), flatten_tree(back)
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.array_equal(got[path], w), path


# ---- one engine step --------------------------------------------------------

# the fake_synthetic recipes' optimizers and schedules, an epoch cut to 1
# step
RECIPES = {
    "resnet18_fcos": ("FCOSLoss", dict(
        name="AdamW", lr=1e-4, weight_decay=1e-3, global_weight_decay=False,
        no_weight_decay_layer_name_list=()), dict(
        scheduler="CosineLR", lr=1e-4, epochs=2, warm_up_epochs=0,
        min_lr=1e-6)),
    "resnet18_retinaface": ("RetinaFaceLoss", dict(
        name="SGD", lr=0.01, momentum=0.9, weight_decay=5e-4,
        global_weight_decay=False, no_weight_decay_layer_name_list=()),
        dict(scheduler="CosineLR", lr=0.01, epochs=2, warm_up_epochs=0)),
}


def _batch(name):
    """Two synthetic 80^2 images on the case's square canvas, through the
    port's collater."""
    kwargs, side = MODEL_CASES[name]
    ds = FakeDetectionDataset(2, 80, kwargs.get("num_classes", 1),
                              transform=Normalize())
    batch = DetectionCollater(side, resize_type="yolo_style")(
        [ds[0], ds[1]])
    return {k: batch[k] for k in ("image", "annots")}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_one_engine_step_tracks_jax(name):
    """The step's loss terms within 1e-4 relative, the parameter changes
    as ``_torch_port.assert_updates_agree`` holds them, the running
    statistics within 2e-4."""
    loss_name, opt, sched = RECIPES[name]
    batch = _batch(name)
    jmodel, variables = _variables(name, batch["image"], seed=5)
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**opt),
        jax_schedule.SchedulerConfig(**sched), 1, variables["params"])
    jcfg = jax_engine.EngineConfig()
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, variables["params"]),
        {"batch_stats": jax.tree.map(jnp.asarray,
                                     variables["batch_stats"])}, tx, jcfg)
    with jax_f32():
        jstep = jax_engine.make_train_step(
            jax_det.make_loss_fn(jmodel, JAX_LOSSES.create(loss_name)), tx,
            jcfg, donate=False)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jax.random.PRNGKey(0))

    model = _port(name, variables)
    optimizer, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**sched), 1, model, device="cpu")
    state = port_engine.create_train_state(
        model, optimizer, port_engine.EngineConfig(), device="cpu")
    step = port_engine.make_train_step(
        port_det.make_loss_fn(LOSSES.create(loss_name)),
        port_engine.EngineConfig())
    state, pm = step(state, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
    for key in jm:
        if key != "skipped":
            assert float(jm[key]) > 0, key
            assert float(pm[key]) == pytest.approx(float(jm[key]),
                                                   rel=1e-4), key

    assert_updates_agree(export_jax_params(model), jstate.params,
                         variables["params"], opt)
    want_stats = flatten_tree(jax.tree.map(
        np.asarray, jstate.state_vars["batch_stats"]))
    got_stats = flatten_tree(export_jax_batch_stats(model))
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, atol=2e-4, rtol=2e-4,
                                   err_msg=path)
