"""The port's SAM task adapter against the JAX package's, f32 on the CPU:
``make_loss_fn``, ``sample_error_region_points``, the best-mask prediction,
``SegmentationEvalMeter``, and the slice as a whole: the trainer's per-batch
loop (a point batch with one refinement click between its two optimizer
steps, a box batch, a mask batch) through the port's ``make_train_step``
against the JAX ``make_train_step`` on the same weights and batches."""

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
from simpleaicv_tpu.tasks import interactive_segmentation as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data.interactive_segmentation import (
    FakeSAMSegmentationDataset, SAMBatchCollater)
from simpleaicv_tpu_torch.tasks import interactive_segmentation as port_task

from _torch_port import TINY_SAM, flatten_tree, jax_f32, random_params

IMG = 256   # the global layer's 16x16 = 256 tokens take the flash path
PROMPTS = ("prompt_point", "prompt_box", "prompt_mask")
# the sa_1b/sam_b recipe's optimizer and schedule, an epoch cut to 2 steps
OPT = dict(name="AdamW", lr=1e-4, weight_decay=1e-4,
           global_weight_decay=False, no_weight_decay_layer_name_list=())
SCHED = dict(scheduler="CosineLR", lr=1e-4, epochs=4, warm_up_epochs=1)
STEPS_PER_EPOCH = 2


def _to_torch(batch):
    return {k: None if v is None else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


def _to_jax(batch):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in batch.items()}


def _keep(batch, kind):
    """One prompt kind per batch; the others are None."""
    return {k: (v if k not in PROMPTS or k == kind else None)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def batches():
    """Two batches of two synthetic samples through the port's collater."""
    dataset = FakeSAMSegmentationDataset(4, IMG)
    collater = SAMBatchCollater(resize=IMG, max_points=4,
                                positive_point_num_range=(1, 2))
    return [collater([dataset[i], dataset[i + 1]]) for i in (0, 2)]


@pytest.fixture(scope="module")
def params(batches):
    model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
    batch = _to_jax(batches[0])
    with jax_f32():
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), batch["image"],
            {k: batch[k] for k in PROMPTS}))
    return random_params(shapes["params"], seed=4)


def _port_model(params, **kwargs):
    model = MODELS.create("sam_b", image_size=IMG, dtype=torch.float32,
                          **TINY_SAM, **kwargs)
    return load_jax_params(model, params)


@pytest.mark.parametrize("kind", PROMPTS)
def test_loss_fn_matches_jax(params, batches, kind):
    batch = _keep(batches[0], kind)
    jax_model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
    with jax_f32():
        want, (want_terms, _) = jax.jit(jax_task.make_loss_fn(
            jax_model, JAX_LOSSES.create("SAMMultiLevelLoss")),
            static_argnums=4)(params, {}, _to_jax(batch),
                              jax.random.PRNGKey(0), True)
    model = _port_model(params)
    loss, terms = port_task.make_loss_fn(
        LOSSES.create("SAMMultiLevelLoss"))(model, _to_torch(batch), None,
                                            True)
    assert model.training and loss.dim() == 0 and loss.requires_grad
    assert loss.item() == pytest.approx(float(want), abs=1e-4)
    assert set(terms) == set(want_terms) == {"focal_loss", "dice_loss",
                                            "iou_predict_loss"}
    for key, val in terms.items():
        assert val.item() == pytest.approx(float(want_terms[key]), abs=1e-4)


def _click_inputs(seed, b=3, hw=(12, 16), n=4):
    rng = np.random.RandomState(seed)
    pred = rng.randn(b, 1, *hw).astype(np.float32)
    gt = (rng.rand(b, *hw) > 0.5).astype(np.float32)
    points = np.full((b, n, 3), -1.0, np.float32)
    points[:, 0] = [3.0, 4.0, 1.0]
    points[1, 1] = [5.0, 6.0, 0.0]
    points[2, :] = [1.0, 1.0, 1.0]   # no free slot: the last is overwritten
    return pred, gt, points


def test_deterministic_click_matches_jax():
    pred, gt, points = _click_inputs(0)
    pred[0, 0] = np.where(gt[0] > 0, 1.0, -1.0)   # no error: aborted
    want = jax_task.sample_error_region_points(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(points), rng=None)
    got = port_task.sample_error_region_points(
        *map(torch.from_numpy, (pred, gt, points)), generator=None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), points[0])
    assert got[1, 2, 2] >= 0 and (got[2, :3].numpy() == points[2, :3]).all()


def test_random_click_lies_in_the_error_region():
    """Random mode: the pixel lies in the error region, the label is the
    ground truth's there, the first free slot is filled and nothing else
    changes; the draws follow the generator."""
    pred, gt, points = _click_inputs(1)
    args = list(map(torch.from_numpy, (pred, gt, points)))
    err = np.abs((pred[:, 0] > 0).astype(np.float32) - gt)
    seen = set()
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        got = port_task.sample_error_region_points(*args, generator=g).numpy()
        assert got.shape == points.shape and got.dtype == np.float32
        for i, slot in enumerate((1, 2, 3)):
            x, y, label = got[i, slot]
            assert err[i, int(y), int(x)] == 1
            assert label == gt[i, int(y), int(x)]
            others = np.delete(np.arange(4), slot)
            np.testing.assert_array_equal(got[i, others], points[i, others])
        seen.add(tuple(got[0, 1]))
        again = port_task.sample_error_region_points(
            *args, generator=torch.Generator().manual_seed(seed)).numpy()
        np.testing.assert_array_equal(got, again)
    assert len(seen) > 4  # not the arg-max pixel every time


def test_tiny_error_regions_abort():
    pred, gt, points = _click_inputs(2)
    pred[:, 0] = np.where(gt > 0, 1.0, -1.0)
    pred[1, 0, 0, :9] *= -1    # 9 error pixels: below the threshold of 10
    pred[2, 0, 0, :10] *= -1   # 10: sampled
    got = port_task.sample_error_region_points(
        *map(torch.from_numpy, (pred, gt, points)),
        generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got[:2], points[:2])
    assert got[2, 3, 1] == 0 and got[2, 3, 0] < 10
    loose = port_task.sample_error_region_points(
        *map(torch.from_numpy, (pred, gt, points)), min_error_pixels=9)
    assert loose[1, 2, 2] >= 0


def test_predict_best_mask_matches_jax(params, batches):
    batch = batches[0]
    jax_model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
    with jax_f32():
        want = jax_task.make_predict_best_mask_fn(jax_model)(
            params, {}, jnp.asarray(batch["image"]),
            jnp.asarray(batch["prompt_point"]))
    model = _port_model(params).train()
    got = port_task.make_predict_best_mask_fn()(
        model, torch.from_numpy(batch["image"]),
        torch.from_numpy(batch["prompt_point"]))
    assert got.shape == (2, 1, IMG, IMG) and not got.requires_grad
    assert model.training  # eval mode for the call only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


def test_eval_meter_matches_jax():
    rng = np.random.RandomState(5)
    ours, theirs = port_task.SegmentationEvalMeter(), \
        jax_task.SegmentationEvalMeter()
    assert ours.compute() == theirs.compute()
    for b in (3, 2):
        pred = (rng.rand(b, 20, 20) > 0.5).astype(np.float32)
        gt = (rng.rand(b, 20, 20) > 0.4).astype(np.float32)
        gt[0] = 0   # an empty ground truth
        theirs.update(pred, gt)
        ours.update(torch.from_numpy(pred), torch.from_numpy(gt))
    assert ours.n == theirs.n == 5
    assert ours.compute() == pytest.approx(theirs.compute(), abs=1e-6)


# A bias on the keys shifts every score of a query alike and the softmax
# ignores it, so its true gradient is 0 and Adam divides the rounding noise
# left there by its own size: two AdamW runs part by up to lr (1e-4) per step
# in the key third of the encoder's qkv bias and in the decoder's k_proj
# bias, over at most four steps here. Everywhere else a leaf is held to 3e-5:
# AdamW moves an element by at most lr a step whatever its gradient's size,
# so where a gradient is within a few digits of the f32 rounding noise (the
# first update of the prompt encoder's mask convolutions) the two sides'
# steps differ by a fraction of lr.
KEY_BIAS_ATOL = 5e-4


def _agree(got, want, atol=3e-5):
    got = flatten_tree(got)
    want = flatten_tree(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if path.endswith("k_proj/bias"):
            np.testing.assert_allclose(g, w, atol=KEY_BIAS_ATOL, err_msg=path)
            continue
        if path.endswith("attn/qkv/bias"):
            k_third = slice(len(w) // 3, 2 * len(w) // 3)
            np.testing.assert_allclose(g[k_third], w[k_third],
                                       atol=KEY_BIAS_ATOL, err_msg=path)
            g, w = np.delete(g, k_third), np.delete(w, k_third)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=path)


class Pair:
    """The JAX and the port's engines on one set of seeded SAM weights."""

    def __init__(self, params, accumulation_steps=1):
        engine = dict(accumulation_steps=accumulation_steps)
        self.jmodel = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
        jcfg = jax_engine.EngineConfig(**engine)
        tx, _ = jax_optim.build_optimizer(
            jax_optim.OptimizerConfig(**OPT),
            jax_schedule.SchedulerConfig(**SCHED), STEPS_PER_EPOCH, params)
        self.jstate = jax_engine.create_train_state(
            jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
        self.jstep = jax_engine.make_train_step(
            jax_task.make_loss_fn(self.jmodel,
                                  JAX_LOSSES.create("SAMMultiLevelLoss")),
            tx, jcfg, donate=False)
        self.jpredict = jax_task.make_predict_best_mask_fn(self.jmodel)

        self.model = _port_model(params, use_gradient_checkpoint=True)
        pcfg = port_engine.EngineConfig(**engine)
        opt, _ = port_optim.build_optimizer(
            port_optim.OptimizerConfig(**OPT),
            port_schedule.SchedulerConfig(**SCHED), STEPS_PER_EPOCH,
            self.model, device="cpu")
        self.state = port_engine.create_train_state(self.model, opt, pcfg,
                                                    device="cpu")
        self.step = port_engine.make_train_step(
            port_task.make_loss_fn(LOSSES.create("SAMMultiLevelLoss")), pcfg)
        self.predict = port_task.make_predict_best_mask_fn()

    def advance(self, batch):
        """One optimizer step of both on the same numpy batch; losses and
        every parameter are compared after it."""
        with jax_f32():
            self.jstate, jm = self.jstep(self.jstate, _to_jax(batch),
                                         jax.random.PRNGKey(0))
        _, pm = self.step(self.state, _to_torch(batch))
        assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        for key in ("loss", "focal_loss", "dice_loss", "iou_predict_loss"):
            assert float(pm[key]) == pytest.approx(float(jm[key]), abs=1e-4)
        _agree(export_jax_params(self.model), self.jstate.params)

    def refine(self, batch):
        """The click between two steps on a point batch: the no-grad
        best-mask prediction of each side and the deterministic arg-max
        error pixel, which must agree."""
        with jax_f32():
            jmasks = self.jpredict(self.jstate.params, {},
                                   jnp.asarray(batch["image"]),
                                   jnp.asarray(batch["prompt_point"]))
        want = jax_task.sample_error_region_points(
            jmasks, jnp.asarray(batch["mask"]),
            jnp.asarray(batch["prompt_point"]), rng=None)
        tb = _to_torch(batch)
        masks = self.predict(self.model, tb["image"], tb["prompt_point"])
        got = port_task.sample_error_region_points(
            masks, tb["mask"], tb["prompt_point"], generator=None).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got != batch["prompt_point"]).any()
        return dict(batch, prompt_point=got)


def test_three_batches_match_jax(params, batches):
    """The trainer's loop written out: a point batch takes
    ``decoder_point_iters`` = 2 optimizer steps with one new click between
    them, a box batch and a mask batch one step each."""
    pair = Pair(params)
    point = _keep(batches[0], "prompt_point")
    pair.advance(point)
    pair.advance(pair.refine(point))
    pair.advance(_keep(batches[1], "prompt_box"))
    pair.advance(_keep(batches[0], "prompt_mask"))
    assert pair.state.step == int(pair.jstate.step) == 4
    assert pair.state.optimizer.step_count == 4


@pytest.mark.parametrize("kind", ["prompt_box", "prompt_point"])
def test_accumulated_step_with_none_entries_matches_jax(params, batches,
                                                        kind):
    """Two micro-batches of one image each: the ``None`` prompt entries pass
    through the split."""
    pair = Pair(params, accumulation_steps=2)
    pair.advance(_keep(batches[1], kind))


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_engine_passes_none_entries_through(accumulation_steps):
    """The engine's device check and micro-batch split on a batch with
    ``None`` entries, without SAM: the loss function sees them as None."""
    seen = []
    model = torch.nn.Linear(3, 1)

    def loss_fn(model, batch, generator, train):
        seen.append({k: None if v is None else tuple(v.shape)
                     for k, v in batch.items()})
        return model(batch["x"]).pow(2).mean(), {}

    cfg = port_engine.EngineConfig(accumulation_steps=accumulation_steps)
    opt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(name="SGD", lr=0.1),
        port_schedule.SchedulerConfig(lr=0.1, epochs=2), 4, model,
        device="cpu")
    state = port_engine.create_train_state(model, opt, cfg, device="cpu")
    step = port_engine.make_train_step(loss_fn, cfg)
    _, metrics = step(state, {"x": torch.randn(4, 3), "prompt_box": None})
    rows = 4 // accumulation_steps
    assert seen == [{"x": (rows, 3), "prompt_box": None}] * accumulation_steps
    assert float(metrics["skipped"]) == 0.0 and opt.step_count == 1
    with pytest.raises(ValueError, match=r"batch\['x'\] lies on meta"):
        step(state, {"x": torch.randn(4, 3, device="meta"),
                     "prompt_box": None})
