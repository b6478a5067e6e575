"""The port's semantic- and binary-segmentation task adapters against the
JAX package's, in f32 on the CPU: three engine steps of DeepLabV3+
(SegCELoss, AdamW, PolyLR) and of PFAN salient detection (the criterion
list, AdamW, CosineLR) through each side's ``make_train_step`` on the same
seeded weights and batches, and both evaluators' metrics on the same
weights and batches."""

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
from simpleaicv_tpu.tasks import binary_segmentation as jax_bseg
from simpleaicv_tpu.tasks import semantic_segmentation as jax_seg
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data.segmentation import (
    FakeSegmentationDataset, SegNormalize, SemanticSegmentationCollater)
from simpleaicv_tpu_torch.tasks import binary_segmentation as port_bseg
from simpleaicv_tpu_torch.tasks import semantic_segmentation as port_seg

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

IMG, CLASSES, IGNORE = 64, 5, 255
# the ade20k and combined recipes' optimizers and schedules, an epoch cut
# to 2 steps
OPT = dict(name="AdamW", lr=1e-4, weight_decay=1e-3,
           global_weight_decay=False, no_weight_decay_layer_name_list=())
SCHED = {"deeplab": dict(scheduler="PolyLR", lr=1e-4, epochs=4,
                         warm_up_epochs=1, power=0.9),
         "pfan": dict(scheduler="CosineLR", lr=1e-4, epochs=4,
                      warm_up_epochs=1, min_lr=1e-6)}
STEPS_PER_EPOCH = 2
NETWORKS = {"deeplab": ("resnet18_deeplabv3plus",
                        dict(num_classes=CLASSES, planes=32)),
            "pfan": ("resnet18_pfan_segmentation", {})}
PFAN_LOSSES = ("BinaryBCELoss", "BCEIouloss")


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


def _batches(kind):
    """Three batches of two synthetic 64^2 samples through the port's
    collater; for PFAN the mask binarised and the image on [0, 1] as
    ``fake_synthetic/resnet18_pfan`` has them."""
    ds = FakeSegmentationDataset(6, IMG, CLASSES,
                                 transform=SegNormalize())
    collate = SemanticSegmentationCollater(IMG, IGNORE)
    out = []
    for i in range(0, 6, 2):
        batch = collate([ds[i], ds[i + 1]])
        batch["mask"][:, -4:] = IGNORE
        if kind == "pfan":
            batch = {"image": batch["image"],
                     "mask": ((batch["mask"] > 0) & (batch["mask"] != IGNORE)
                              ).astype(np.float32)}
        else:
            del batch["size"]
        out.append(batch)
    return out


def _variables(kind, batch):
    name, kwargs = NETWORKS[kind]
    with jax_f32():
        model = JAX_MODELS.create(name, **kwargs)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["image"]), False))
    return {"params": random_params(shapes["params"], seed=5),
            "batch_stats": random_batch_stats(shapes["batch_stats"], seed=6)}


def _port_model(kind, variables):
    name, kwargs = NETWORKS[kind]
    return load_jax_params(MODELS.create(name, dtype=torch.float32, **kwargs),
                           variables["params"],
                           batch_stats=variables["batch_stats"])


def _loss_fns(kind, jmodel):
    """(JAX loss_fn, port loss_fn) of the task."""
    if kind == "deeplab":
        return (jax_seg.make_loss_fn(jmodel, JAX_LOSSES.create(
            "SegCELoss", ignore_index=IGNORE)),
                port_seg.make_loss_fn(LOSSES.create("SegCELoss",
                                                    ignore_index=IGNORE)))
    return (jax_bseg.make_loss_fn(jmodel, [(n, 1.0, JAX_LOSSES.create(n))
                                           for n in PFAN_LOSSES]),
            port_bseg.make_loss_fn([(n, 1.0, LOSSES.create(n))
                                    for n in PFAN_LOSSES]))


# PFAN's BatchNorms whose output meets only a 1x1 convolution and then a
# train-mode BatchNorm, which removes any per-channel constant: the
# gradient of their bias is exactly 0, and both sides' is rounding noise,
# which AdamW turns into steps of lr either way
ZERO_GRADIENT = ("decoder/high_level_conv/bn/bias",
                 "decoder/low_level_conv/bn/bias")
STEPS = 3


def _agree_in_l2(got, want, start):
    """Each leaf's change since ``start`` within 15% of the JAX change in L2
    and at a cosine above 0.99. AdamW's first updates are the sign of each
    gradient element, and train-mode BatchNorm leaves some elements near
    their rounding: DeepLabV3+'s train-mode logits part from an f64 run of
    the port by 2.3e-4 of their largest value on the JAX side and 6e-7 on
    the port's, and the leaves' changes part by up to 10.6% (backbone
    BatchNorm scales), at cosines above 0.994. A leaf of ``ZERO_GRADIENT``
    moves by at most lr a step on either side."""
    got, want, start = (flatten_tree(t) for t in (got, want, start))
    assert set(got) == set(want) == set(start)
    for path, w in want.items():
        dw, dg = w - start[path], got[path] - start[path]
        if path in ZERO_GRADIENT:
            bound = STEPS * OPT["lr"] * (1 + 1e-3)
            assert max(np.abs(dw).max(), np.abs(dg).max()) <= bound, path
            continue
        norm = np.linalg.norm(dw)
        assert np.linalg.norm(dg - dw) <= 0.15 * norm, path
        cos = np.dot(dg.ravel(), dw.ravel()) / (np.linalg.norm(dg) * norm)
        assert cos > 0.99, (path, cos)


@pytest.mark.parametrize("kind", ["deeplab", "pfan"])
def test_three_engine_steps_track_jax(kind):
    batches = _batches(kind)
    variables = _variables(kind, batches[0])
    name, kwargs = NETWORKS[kind]
    jmodel = JAX_MODELS.create(name, **kwargs)
    jax_loss, port_loss = _loss_fns(kind, jmodel)
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**OPT),
        jax_schedule.SchedulerConfig(**SCHED[kind]), STEPS_PER_EPOCH,
        variables["params"])
    jcfg = jax_engine.EngineConfig()
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, variables["params"]),
        {"batch_stats": jax.tree.map(jnp.asarray,
                                     variables["batch_stats"])}, tx, jcfg)
    with jax_f32():
        jstep = jax_engine.make_train_step(jax_loss, tx, jcfg, donate=False)

    model = _port_model(kind, variables)
    opt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**OPT),
        port_schedule.SchedulerConfig(**SCHED[kind]), STEPS_PER_EPOCH,
        model, device="cpu")
    state = port_engine.create_train_state(
        model, opt, port_engine.EngineConfig(), device="cpu")
    step = port_engine.make_train_step(port_loss, port_engine.EngineConfig())

    assert len(batches) == STEPS
    for batch in batches:
        with jax_f32():
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(0))
        state, pm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        for key in jm:
            if key != "skipped":
                assert float(pm[key]) == pytest.approx(float(jm[key]),
                                                       rel=1e-4), key
    assert state.step == int(jstate.step) == STEPS
    assert state.optimizer.step_count == STEPS
    _agree_in_l2(export_jax_params(model), jax.tree.map(np.asarray,
                                                        jstate.params),
                 variables["params"])
    want_stats = flatten_tree(jax.tree.map(
        np.asarray, jstate.state_vars["batch_stats"]))
    got_stats = flatten_tree(export_jax_batch_stats(model))
    assert set(got_stats) == set(want_stats)
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, atol=2e-4, rtol=2e-4,
                                   err_msg=path)


@pytest.mark.parametrize("kind", ["deeplab", "pfan"])
def test_evaluator_matches_jax(kind):
    """The class areas (DeepLabV3+, 255 ignored) or the thresholded IoU sums
    (PFAN) of two batches in eval mode, accumulated into the metrics."""
    batches = _batches(kind)
    variables = _variables(kind, batches[0])
    name, kwargs = NETWORKS[kind]
    jmodel = JAX_MODELS.create(name, **kwargs)
    if kind == "deeplab":
        jeval = jax_seg.make_evaluate(CLASSES, IGNORE)
        jstep = jax_engine.make_eval_step(jax_seg.make_eval_fn(
            jmodel, CLASSES, IGNORE))
        peval = port_seg.make_evaluate(CLASSES)
        pstep = port_engine.make_eval_step(
            port_seg.make_eval_fn(CLASSES, IGNORE), device="cpu")
    else:
        # the random weights' probabilities lie on one side of 0.5: a
        # threshold at their median splits them
        with torch.no_grad():
            threshold = float(np.median(_port_model(kind, variables).eval()(
                torch.from_numpy(batches[0]["image"])).numpy()))
        jeval = jax_bseg.make_evaluate()
        jstep = jax_engine.make_eval_step(jax_bseg.make_eval_fn(
            jmodel, threshold))
        peval = port_bseg.make_evaluate()
        pstep = port_engine.make_eval_step(
            port_bseg.make_eval_fn(threshold), device="cpu")
    with jax_f32():
        want = jeval(jstep, jax.tree.map(jnp.asarray, variables["params"]),
                     {"batch_stats": variables["batch_stats"]}, batches,
                     lambda b: jax.tree.map(jnp.asarray, b))
    model = _port_model(kind, variables)
    got = peval(pstep, model, batches,
                lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, rel=1e-5, abs=1e-9), key
    assert 0 < want["key_metric"] < (100 if kind == "deeplab" else 1)


def test_class_areas_count_only_valid_pixels():
    """The areas of one batch: ignored pixels count nowhere, labels and
    predictions beyond the classes are clamped into the last."""

    class Fixed(torch.nn.Module):
        def forward(self, x, train=None, generator=None):
            return x

    logits = torch.zeros(1, 2, 3, 3)
    logits[0, 0, :, 0] = 1.0   # predicts class 0 on row 0, class 2 on row 1
    logits[0, 1, :, 2] = 1.0
    mask = torch.tensor([[[0, 1, 255], [2, 7, 0]]])
    m = port_seg.make_eval_fn(3, 255)(Fixed(), {"image": logits,
                                                "mask": mask}, None, False)
    # valid pixels: predictions [0, 0, 2, 2, 2], labels [0, 1, 2, 7, 0],
    # label 7 counted as class 2 but unequal to the prediction 2
    assert m["area_pred"].tolist() == [2.0, 0.0, 3.0]
    assert m["area_gt"].tolist() == [2.0, 1.0, 2.0]
    assert m["area_intersect"].tolist() == [1.0, 0.0, 1.0]
