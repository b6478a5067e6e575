"""The port's train engine against the JAX package's ``make_train_step`` on
the same seeded weights and batches (tiny ViT, f32, CPU): single steps and
four-step trajectories with accumulation, both clips and EMA, the
non-finite skip, buffer restoration, and the eval step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.losses.classification import CELoss as JaxCELoss
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT
from simpleaicv_tpu.tasks import classification as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.weights import (export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.losses.classification import CELoss
from simpleaicv_tpu_torch.models.backbones.vit import ViT
from simpleaicv_tpu_torch.tasks import classification as port_task

from _torch_port import flatten_tree, jax_f32, random_params

TINY = dict(patch_size=8, embedding_planes=64, block_nums=2, head_nums=2,
            image_size=32, num_classes=10, use_flash_attention=True,
            global_pool=True)
STEPS_PER_EPOCH = 2

RECIPES = {
    # the ViT-B/16 recipe: AdamW, layer-wise lr decay, warm-up cosine
    "adamw": (dict(name="AdamW", lr=1e-3, weight_decay=0.05,
                   no_weight_decay_layer_name_list=("position_encoding",
                                                    "cls_token"),
                   lr_layer_decay=0.75, lr_layer_decay_block_nums=2,
                   block_name="blocks"),
              dict(scheduler="CosineLR", lr=1e-3, epochs=4, warm_up_epochs=1,
                   min_lr=1e-6)),
    "sgd": (dict(name="SGD", lr=0.05, weight_decay=1e-4, momentum=0.9),
            dict(scheduler="CosineLR", lr=0.05, epochs=4)),
}
ENGINE = dict(accumulation_steps=2, use_ema=True, ema_decay=0.9,
              clip_grad_value=0.5, clip_max_norm=1.0)


def _batch(seed, n=8, poison=False):
    rng = np.random.RandomState(seed)
    image = rng.randn(n, 32, 32, 3).astype(np.float32)
    if poison:
        image[1, 3, 3, 0] = np.inf
    return {"image": image, "label": rng.randint(0, 10, (n,)).astype(np.int32)}


def _to_torch(batch):
    return {"image": torch.from_numpy(batch["image"]),
            "label": torch.from_numpy(batch["label"]).long()}


class Pair:
    """The JAX and the port's engines on one set of seeded weights."""

    def __init__(self, recipe, engine=ENGINE, seed=0):
        opt_fields, sched_fields = RECIPES[recipe]
        with jax_f32():
            self.jmodel = JaxViT(**TINY)
            tree = jax.eval_shape(self.jmodel.init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 32, 3)))["params"]
        params = random_params(tree, seed=seed)
        jcfg = jax_engine.EngineConfig(**engine)
        tx, _ = jax_optim.build_optimizer(
            jax_optim.OptimizerConfig(**opt_fields),
            jax_schedule.SchedulerConfig(**sched_fields), STEPS_PER_EPOCH,
            params)
        self.jstate = jax_engine.create_train_state(
            jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
        self.adam = opt_fields["name"] == "AdamW"
        self.jstep = jax_engine.make_train_step(
            jax_task.make_loss_fn(self.jmodel, JaxCELoss()), tx, jcfg,
            donate=False)

        self.model = load_jax_params(ViT(**TINY, dtype=torch.float32), params)
        pcfg = port_engine.EngineConfig(**engine)
        opt, _ = port_optim.build_optimizer(
            port_optim.OptimizerConfig(**opt_fields),
            port_schedule.SchedulerConfig(**sched_fields), STEPS_PER_EPOCH,
            self.model, device="cpu")
        self.state = port_engine.create_train_state(self.model, opt, pcfg,
                                                    device="cpu")
        self.step = port_engine.make_train_step(
            port_task.make_loss_fn(CELoss()), pcfg)

    def advance(self, batch):
        with jax_f32():
            self.jstate, jm = self.jstep(
                self.jstate, jax.tree.map(jnp.asarray, batch),
                jax.random.PRNGKey(0))
        state, pm = self.step(self.state, _to_torch(batch))
        assert state is self.state
        return ({k: float(v) for k, v in jm.items()},
                {k: float(v) for k, v in pm.items()})

    def agree(self, atol=1e-5):
        """Parameters, EMA and optimizer moments, in the JAX layout. Only
        AdamW's parameters and their EMA get the key-bias allowance; the
        moments, and everything under SGD, are held to atol throughout."""
        names = self.state.optimizer.names
        loose = KEY_BIAS_ATOL if self.adam else None
        pairs = [(self.jstate.params, None, loose),
                 (self.jstate.ema_params, self.state.ema_params, loose)]
        fields = lambda x: set(getattr(x, "_fields", ()))  # noqa: E731
        found = jax.tree.leaves(
            self.jstate.opt_state,
            is_leaf=lambda x: bool(fields(x) & {"mu", "trace"}))
        for s in found:
            for key in fields(s) & {"mu", "nu", "trace"}:
                pairs.append((getattr(s, key), dict(zip(
                    names, self.state.optimizer.moments[key])), None))
        assert len(pairs) >= 3
        for want, tensors, key_bias_atol in pairs:
            _agree(export_jax_params(self.model, tensors), want, atol,
                   key_bias_atol)


# A bias on the keys shifts every score of a query alike and the softmax
# ignores it: its true gradient is 0, and Adam divides the rounding noise left
# there by its own size, so two AdamW runs part by up to lr (1e-3) per step in
# those parameters, over at most five steps here.
KEY_BIAS_ATOL = 5e-3


def _agree(got, want, atol=1e-5, key_bias_atol=None):
    """Every leaf within atol; with ``key_bias_atol``, the key third of each
    ``attn/qkv/bias`` is held to that bound instead."""
    got = flatten_tree(got)
    for path, w in flatten_tree(want).items():
        g = got[path]
        if key_bias_atol is not None and path.endswith("attn/qkv/bias"):
            k_third = slice(len(w) // 3, 2 * len(w) // 3)
            np.testing.assert_allclose(g[k_third], w[k_third],
                                       atol=key_bias_atol, err_msg=path)
            g, w = np.delete(g, k_third), np.delete(w, k_third)
        np.testing.assert_allclose(g, w, atol=atol, err_msg=path)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_one_step_matches_jax(recipe):
    pair = Pair(recipe)
    jm, pm = pair.advance(_batch(0))
    assert pm["loss"] == pytest.approx(jm["loss"], abs=1e-5)
    assert pm["skipped"] == jm["skipped"] == 0.0
    pair.agree()
    assert pair.state.step == int(pair.jstate.step) == 1


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_four_step_trajectory_matches_jax(recipe):
    pair = Pair(recipe, seed=1)
    for i in range(4):
        jm, pm = pair.advance(_batch(10 + i))
        assert pm["loss"] == pytest.approx(jm["loss"], abs=1e-5), i
        assert pm["skipped"] == 0.0
    pair.agree()
    assert pair.state.optimizer.step_count == 4


def test_no_accumulation_no_clip_no_ema_matches_jax():
    pair = Pair("adamw", engine=dict(accumulation_steps=1, use_ema=False))
    assert pair.state.ema_params is None
    for i in range(2):
        jm, pm = pair.advance(_batch(20 + i, n=4))
        assert pm["loss"] == pytest.approx(jm["loss"], abs=1e-5)
    _agree(export_jax_params(pair.model), pair.jstate.params,
           key_bias_atol=KEY_BIAS_ATOL)


def test_non_finite_batch_is_skipped_like_jax():
    pair = Pair("adamw", seed=2)
    pair.advance(_batch(30))
    opt = pair.state.optimizer
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    moments = {k: [t.clone() for t in v] for k, v in opt.moments.items()}
    ema = {k: v.clone() for k, v in pair.state.ema_params.items()}
    lrs = opt.leaf_lrs()

    jm, pm = pair.advance(_batch(31, poison=True))
    assert pm["skipped"] == jm["skipped"] == 1.0
    assert not np.isfinite(pm["loss"])
    # parameters and optimizer state stay, its step count included
    for k, v in pair.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for key, tensors in opt.moments.items():
        assert all(torch.equal(a, b) for a, b in zip(tensors, moments[key]))
    assert opt.step_count == 1 and opt.leaf_lrs() == lrs
    # the engine's step advances and EMA updates, from the unchanged params
    assert pair.state.step == int(pair.jstate.step) == 2
    for k, v in pair.state.ema_params.items():
        torch.testing.assert_close(v, 0.9 * ema[k] + 0.1 * before[k],
                                   atol=1e-6, rtol=0)  # f32 rounding
    assert all(p.grad is None for p in pair.model.parameters())
    pair.agree()

    # the next good step takes the schedule's second rate, as JAX does
    jm, pm = pair.advance(_batch(32))
    assert pm["skipped"] == 0.0 and opt.step_count == 2
    assert pm["loss"] == pytest.approx(jm["loss"], abs=1e-5)
    pair.agree()


def test_skip_can_be_turned_off():
    pair = Pair("sgd", engine=dict(skip_non_finite=False))
    _, pm = pair.advance(_batch(40, poison=True))
    assert pm["skipped"] == 0.0
    assert pair.state.optimizer.step_count == 1


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(6, 8)
        self.bn = nn.BatchNorm1d(8)
        self.fc2 = nn.Linear(8, 3)

    def forward(self, x, generator=None):
        return self.fc2(torch.relu(self.bn(self.fc1(x))))


def test_buffers_are_restored_on_skip():
    torch.manual_seed(0)
    model = _Toy()
    cfg = port_engine.EngineConfig(accumulation_steps=2)
    opt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(name="SGD", lr=0.1),
        port_schedule.SchedulerConfig(lr=0.1, epochs=2), 4, model,
        device="cpu")
    state = port_engine.create_train_state(model, opt, cfg, device="cpu")
    step = port_engine.make_train_step(port_task.make_loss_fn(CELoss()), cfg)
    g = torch.Generator().manual_seed(1)
    good = {"image": torch.randn(8, 6, generator=g),
            "label": torch.randint(0, 3, (8,), generator=g)}
    _, m = step(state, good)
    assert float(m["skipped"]) == 0.0
    assert int(model.bn.num_batches_tracked) == 2  # one per micro-batch
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    params = {k: v.clone() for k, v in model.named_parameters()}

    bad = {"image": good["image"].clone(), "label": good["label"]}
    bad["image"][5, 2] = float("nan")  # in the second micro-batch only
    _, m = step(state, bad)
    assert float(m["skipped"]) == 1.0
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    for k, v in model.named_parameters():
        assert torch.equal(v, params[k]), k
    assert state.step == 2 and opt.step_count == 1

    _, m = step(state, good)
    assert float(m["skipped"]) == 0.0 and opt.step_count == 2
    assert int(model.bn.num_batches_tracked) == 4
    assert not torch.equal(model.bn.running_mean, buffers["bn.running_mean"])


def test_step_generator_is_a_function_of_seed_and_step():
    draw = lambda seed, step: torch.rand(  # noqa: E731
        4, generator=port_engine.step_generator(torch.Generator(), seed,
                                                step))
    assert torch.equal(draw(3, 7), draw(3, 7))
    assert not torch.equal(draw(3, 7), draw(3, 8))
    assert not torch.equal(draw(3, 7), draw(4, 7))


def test_augment_hook_sees_the_global_batch():
    seen = []

    def augment(batch, generator):
        seen.append((batch["image"].shape[0], generator))
        return dict(batch, image=batch["image"] * 0.5)

    pair = Pair("sgd")
    step = port_engine.make_train_step(
        port_task.make_loss_fn(CELoss()),
        port_engine.EngineConfig(accumulation_steps=2), augment_fn=augment)
    step(pair.state, _to_torch(_batch(50)))
    assert seen[0][0] == 8 and isinstance(seen[0][1], torch.Generator)


def test_eval_step_counts_match_jax():
    pair = Pair("sgd", seed=3)
    batch = _batch(60, n=16)
    batch["label"][[2, 9, 15]] = -1  # padding examples
    with jax_f32():
        jstep = jax_engine.make_eval_step(jax_task.make_eval_fn(pair.jmodel))
        want = jstep(pair.jstate.params, {},
                     jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))
    step = port_engine.make_eval_step(port_task.make_eval_fn(), device="cpu")
    got = step(pair.model, _to_torch(batch))
    assert not pair.model.training
    for key in ("acc1_correct", "acc5_correct", "n"):
        assert float(got[key]) == float(want[key]), key
    assert float(got["n"]) == 13.0

    # known logits: top-1 of rows 0 and 1, top-5 of rows 0, 1 and 2
    logits = torch.zeros(4, 10)
    logits[0, 3], logits[1, 4] = 5.0, 5.0
    logits[2, :5] = torch.tensor([5.0, 4.0, 3.0, 2.0, 1.0])
    logits[3, 5:] = 1.0
    known = step(nn.Identity(), {"image": logits,
                                 "label": torch.tensor([3, 4, 4, 0])})
    assert [float(known[k]) for k in ("acc1_correct", "acc5_correct", "n")] \
        == [2.0, 3.0, 4.0]
    result = port_task.evaluate(
        step, nn.Identity(),
        [{"image": logits, "label": torch.tensor([3, 4, 4, -1])}] * 2,
        lambda b: b)
    assert result == {"acc1": pytest.approx(200 / 3),
                      "acc5": pytest.approx(100.0),
                      "key_metric": pytest.approx(200 / 3)}


class _JaxIdentity:
    """A JAX model whose logits are its input."""

    @staticmethod
    def apply(variables, x, train):
        return x


def test_top_k_breaks_ties_as_jax():
    """Among tied logits the highest index wins, in top-1 and top-5."""
    step = port_engine.make_eval_step(port_task.make_eval_fn(), device="cpu")
    jax_eval = jax.jit(jax.vmap(
        lambda x, y: jax_task.make_eval_fn(_JaxIdentity())(
            {}, {}, {"image": x[None], "label": y[None]}, None, False)))
    logits = torch.tensor([[0.5, 2, 2, 1, 2, -1, 0]])
    top1 = [float(step(nn.Identity(), {"image": logits,
                                       "label": torch.tensor([c])})
                  ["acc1_correct"]) for c in range(7)]
    want = jax_eval(jnp.asarray(logits.numpy()), jnp.array([4]))
    assert top1 == [0, 0, 0, 0, 1, 0, 0]
    assert float(want["acc1_correct"][0]) == 1.0

    # the whole top-1 and top-5 masks on a seeded bf16 batch with ties:
    # every (row, class) pair is one example
    rows, classes = 6, 9
    x = np.random.RandomState(7).randint(0, 4, (rows, classes)) * 0.5
    image = np.repeat(x, classes, axis=0)
    label = np.tile(np.arange(classes), rows)
    want = jax_eval(jnp.asarray(image, jnp.bfloat16), jnp.asarray(label))
    for key in ("acc1_correct", "acc5_correct"):
        got = [float(step(nn.Identity(), {
            "image": torch.tensor(image[i:i + 1], dtype=torch.bfloat16),
            "label": torch.tensor(label[i:i + 1])})[key])
            for i in range(rows * classes)]
        np.testing.assert_array_equal(
            np.reshape(got, (rows, classes)),
            np.asarray(want[key]).reshape(rows, classes), err_msg=key)


def _toy_optimizer(model, device):
    return port_optim.build_optimizer(
        port_optim.OptimizerConfig(name="AdamW", lr=0.1),
        port_schedule.SchedulerConfig(lr=0.1, epochs=2), 4, model,
        **device)[0]


ENTRY_POINTS = {
    "build_optimizer": lambda device: _toy_optimizer(_Toy(), device),
    "create_train_state": lambda device: port_engine.create_train_state(
        _Toy(), _toy_optimizer(_Toy(), dict(device="cpu")),
        port_engine.EngineConfig(), **device),
    "make_eval_step": lambda device: port_engine.make_eval_step(
        port_task.make_eval_fn(), **device),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(entry):
    """The engine's entry points run on the card unless told otherwise:
    with no ``device`` argument and no card they raise and do not carry on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]({})
    assert ENTRY_POINTS[entry](dict(device="cpu")) is not None


def test_state_is_moved_to_its_device():
    """``create_train_state`` takes the model, the moments and the EMA to
    its device (shown with the ``meta`` device, the only other one here),
    keeping the optimizer's hold on the parameters."""
    model = _Toy()
    opt = _toy_optimizer(model, dict(device="cpu"))
    state = port_engine.create_train_state(
        model, opt, port_engine.EngineConfig(use_ema=True), device="meta")
    assert state.device.type == "meta"
    assert all(p.device.type == "meta" for p in model.parameters())
    assert all(a is b for a, b in zip(opt.params, model.parameters()))
    assert all(t.device.type == "meta"
               for tensors in opt.moments.values() for t in tensors)
    assert all(t.device.type == "meta" for t in state.ema_params.values())


def test_steps_raise_on_a_batch_or_model_elsewhere():
    cfg = port_engine.EngineConfig()
    model = _Toy()
    state = port_engine.create_train_state(
        model, _toy_optimizer(model, dict(device="cpu")), cfg, device="cpu")
    step = port_engine.make_train_step(port_task.make_loss_fn(CELoss()), cfg)
    batch = {"image": torch.randn(4, 6),
             "label": torch.zeros(4, dtype=torch.long, device="meta")}
    with pytest.raises(ValueError, match=r"batch\['label'\] lies on meta"):
        step(state, batch)
    assert state.step == 0 and state.optimizer.step_count == 0
    eval_step = port_engine.make_eval_step(port_task.make_eval_fn(),
                                           device="cpu")
    with pytest.raises(ValueError, match="the model lies on meta"):
        eval_step(_Toy().to("meta"), dict(batch, label=torch.zeros(4).long()))
