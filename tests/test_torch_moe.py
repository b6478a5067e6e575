"""The port's Mixture-of-Experts layer and ViT-MoE (``simpleaicv_tpu_torch/
parallel/moe.py``, ``models/backbones/vit_moe.py``) against the JAX
package's on the CPU, in f32, on the same weights:

* the index routing (slots, gates, load-balance loss) and the one-hot form
  (the JAX formula, apart from the index routing) against JAX
  ``top_k_dispatch``, at top-1 and top-2, with
  and without drops past capacity: the dispatch exactly, the combine and
  the loss to 1e-6;
* the router z-loss;
* ``MoEFeedForward``'s output, auxiliary loss and gradients to 1e-5;
* the expert product's backward on bf16 operands keeps the f32 output
  gradient unrounded, as the JAX einsum's transpose does;
* a tiny ViT-MoE's logits, auxiliary loss and gradients to 1e-4 (with the
  port on its einsum and its flash path);
* one engine step with ``moe_aux_weight`` against the JAX step (SGD, each
  parameter to 1e-5);
* the Trainer passes ``config.moe_aux_weight`` to the loss.

A top-k choice within rounding of a tie could go either way on either side:
the inputs are drawn until every token's top-3 router probabilities are
1e-3 apart in relative terms, and the routing is asserted equal before
values are compared.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.losses.classification import CELoss as JaxCELoss
from simpleaicv_tpu.models.backbones.vit_moe import ViTMoE as JaxViTMoE
from simpleaicv_tpu.parallel import moe as jax_moe
from simpleaicv_tpu.tasks import classification as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.trainer import Trainer
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.data.collater import ClassificationCollater
from simpleaicv_tpu_torch.data.datasets import FakeClassificationDataset
from simpleaicv_tpu_torch.losses.classification import CELoss
from simpleaicv_tpu_torch.models.backbones.vit_moe import ViTMoE
from simpleaicv_tpu_torch.models.common import init_params
from simpleaicv_tpu_torch.parallel import moe

from _torch_port import flatten_tree, jax_f32, one_torch_thread

C, H, E = 16, 32, 4
TINY = dict(patch_size=8, embedding_planes=32, block_nums=4, head_nums=2,
            num_experts=4, top_k=2, capacity_factor=1.0, image_size=32,
            num_classes=10, global_pool=True)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _margin(probs):
    """The least gap between the logarithms of a token's three largest
    probabilities (a relative gap: rounding moves them by about 1e-7)."""
    top = np.log(np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
                 [:, :3])
    return float(np.diff(-top, axis=-1).min())


def _probs(seed, t=40, e=E):
    """Router softmax [T, E] with clear top-3 margins."""
    for s in range(seed, seed + 100):
        logits = np.random.RandomState(s).randn(t, e).astype(np.float32) * 2
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        if _margin(probs) > 1e-3:
            return probs
    raise AssertionError("no seed with clear margins")


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity", [40, 7])  # no drops; drops
def test_routing_matches_jax_top_k_dispatch(top_k, capacity):
    probs = _probs(top_k * 10 + capacity)
    jd, jc, jaux = jax_moe.top_k_dispatch(jnp.asarray(probs), capacity,
                                          top_k)
    slots, gates, aux = moe.top_k_route(torch.from_numpy(probs), capacity,
                                        top_k)
    d, c, aux2 = moe.top_k_dispatch(torch.from_numpy(probs), capacity, top_k)
    jd, jc = np.asarray(jd), np.asarray(jc)
    if capacity == 7:
        assert (jd.sum(axis=(1, 2)) < top_k).any()  # some choices dropped
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux2) == float(aux)
    # the slots are the dispatch's (token, expert * cap + position) cells
    flat = jd.reshape(jd.shape[0], -1)
    for slot, g in zip(slots, gates):
        kept = slot.numpy() >= 0
        assert (flat[np.arange(len(slot))[kept], slot.numpy()[kept]]
                == 1.0).all()
        assert (g.numpy()[~kept] == 0.0).all()
    # every buffer cell holds at most one token
    assert jd.sum(axis=0).max() <= 1.0


def _jax_layer(**kw):
    with jax_f32():
        return jax_moe.MoEFeedForward(hidden=H, num_experts=E, **kw)


def _layer_params(seed):
    rng = np.random.RandomState(seed)
    return {"router": rng.randn(C, E).astype(np.float32),
            "wi": (rng.randn(E, C, H) / np.sqrt(C)).astype(np.float32),
            "bi": (0.1 * rng.randn(E, 1, H)).astype(np.float32),
            "wo": (rng.randn(E, H, C) / np.sqrt(H)).astype(np.float32),
            "bo": (0.1 * rng.randn(E, 1, C)).astype(np.float32)}


def _port_layer(params, **kw):
    layer = moe.MoEFeedForward(C, H, num_experts=E, dtype=torch.float32,
                               **kw)
    with torch.no_grad():
        for k, v in params.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    return layer


def _clear_inputs(params, seed, shape=(2, 12, C)):
    for s in range(seed, seed + 100):
        x = np.random.RandomState(s).randn(*shape).astype(np.float32)
        probs = jax.nn.softmax(x.reshape(-1, C) @ params["router"], axis=-1)
        if _margin(probs) > 1e-3:
            return x
    raise AssertionError("no seed with clear margins")


def test_router_z_loss_value():
    """Zero router weights: uniform probabilities give a load-balance loss
    of exactly 1 and logits of 0 a z-loss of log(E)^2; the port's layer at
    router_z_weight 1 against the JAX layer's sown value."""
    params = {k: np.zeros_like(v) for k, v in _layer_params(0).items()}
    x = np.random.RandomState(1).randn(1, 24, C).astype(np.float32)
    layer = _port_layer(params, top_k=1, router_z_weight=1.0)
    layer(torch.from_numpy(x))
    want = 1.0 + float(np.log(E))**2
    np.testing.assert_allclose(float(layer.aux_loss), want, rtol=1e-6)
    jl = _jax_layer(top_k=1, router_z_weight=1.0)
    with jax_f32():
        _, muts = jl.apply({"params": params}, jnp.asarray(x),
                           mutable=["moe_losses"])
    np.testing.assert_allclose(float(layer.aux_loss),
                               float(jax_moe.moe_aux_loss(muts)), rtol=1e-6)


@pytest.mark.parametrize("top_k,capacity_factor",
                         [(1, 4.0), (2, 4.0), (2, 0.5)])
def test_moe_feedforward_output_aux_and_gradients(top_k, capacity_factor):
    """Output, auxiliary loss (load balance + z) and the gradients of
    sum(y * dy) + 0.3 aux for every parameter and the input, to 1e-5."""
    params = _layer_params(2)
    x = _clear_inputs(params, 3)
    dy = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jl = _jax_layer(top_k=top_k, capacity_factor=capacity_factor)

    def jloss(p, x):
        y, muts = jl.apply({"params": p}, x, mutable=["moe_losses"])
        aux = jax_moe.moe_aux_loss(muts)
        return jnp.sum(y * dy) + 0.3 * aux, (y, aux)

    with jax_f32():
        (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
                jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    layer = _port_layer(params, top_k=top_k,
                        capacity_factor=capacity_factor)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer(xt)
    (y * torch.from_numpy(dy)).sum().add(0.3 * layer.aux_loss).backward()
    cap = layer.capacity(x.shape[0] * x.shape[1])
    if capacity_factor < 1.0:
        assert float(layer.dropped) > 0.0
        assert cap < x.shape[0] * x.shape[1] * top_k / E
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(layer.aux_loss), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for k in params:
        np.testing.assert_allclose(getattr(layer, k).grad.numpy(),
                                   np.asarray(jgp[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_expert_product_backward_keeps_the_f32_gradient():
    """The expert product on bf16 operands against the JAX einsum's
    (``preferred_element_type=f32``) vjp on an f32 cotangent: the bf16
    gradients of both operands within one bf16 step, in at most 0.1% of
    the elements unequal (the order of an f32 sum); a cotangent rounded to
    bf16 first parts in about 40%."""
    rng = np.random.RandomState(7)
    a = rng.randn(E, 48, C * 4).astype(np.float32)
    b = (rng.randn(E, C * 4, H * 3) / 8).astype(np.float32)
    g = rng.randn(E, 48, H * 3).astype(np.float32)
    ja, jb = (jnp.asarray(v, jnp.bfloat16) for v in (a, b))
    _, vjp = jax.vjp(lambda x, y: jnp.einsum(
        "ecd,edf->ecf", x, y, preferred_element_type=jnp.float32), ja, jb)
    want = [torch.from_numpy(np.array(v.astype(jnp.float32)))
            for v in vjp(jnp.asarray(g))]
    ta, tb = (torch.from_numpy(np.array(v.astype(jnp.float32)))
              .bfloat16().requires_grad_() for v in (ja, jb))
    out = moe._ExpertProduct.apply(ta, tb)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    for got, ref in zip((ta.grad, tb.grad), want):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=2 ** -8, atol=0)
        assert (got.float() != ref).float().mean() <= 1e-3


def test_main_path_builds_no_one_hot_dispatch(monkeypatch):
    """The layer's forward and backward never call the one-hot form."""
    def refuse(*args, **kwargs):
        raise AssertionError("the one-hot dispatch was built")

    monkeypatch.setattr(moe, "top_k_dispatch", refuse)
    params = _layer_params(5)
    layer = _port_layer(params)
    layer(torch.randn(2, 8, C, requires_grad=True)).sum().backward()
    assert layer.wi.grad is not None


# ---------------------------------------------------------------- ViT-MoE


def _jax_vit():
    with jax_f32():
        return JaxViTMoE(**TINY)


def _vit_params(seed):
    """The tiny ViT-MoE's JAX tree with seeded weights; the routers large
    enough for clear choices."""
    jm = _jax_vit()
    with jax_f32():
        tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in flatten_tree(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), tree)).items():
        name = path.split("/")[-1]
        if name == "kernel":
            arr = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("wi", "wo"):
            arr = rng.randn(*leaf.shape) / np.sqrt(leaf.shape[1])
        elif name == "router":
            arr = 0.5 * rng.randn(*leaf.shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:
            arr = 0.1 * rng.randn(*leaf.shape)
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr.astype(np.float32)
    return out


def _router_probs(model, images):
    """Each MoE layer's router probabilities in the port model's forward."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(torch.softmax(
            args[0].reshape(-1, args[0].shape[-1]).float() @ mod.router,
            -1).detach().numpy()))
        for m in model.modules() if isinstance(m, moe.MoEFeedForward)]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    return seen


def _clear_vit_case(model, n=4):
    for s in range(100):
        image = np.random.RandomState(s).randn(n, 32, 32, 3).astype(
            np.float32)
        probs = _router_probs(model, torch.from_numpy(image))
        if len(probs) == 2 and min(_margin(p) for p in probs) > 1e-3:
            return image
    raise AssertionError("no batch with clear router margins")


@pytest.fixture(scope="module")
def vit_case():
    params = _vit_params(0)
    model = load_jax_params(ViTMoE(**TINY, dtype=torch.float32), params)
    return params, _clear_vit_case(model.train())


def test_vit_moe_weights_carry_both_ways(vit_case):
    params, _ = vit_case
    model = load_jax_params(ViTMoE(**TINY, dtype=torch.float32), params)
    paths = jax_paths(model)
    assert paths["blocks.1.moe_mlp.wi"] == "blocks_1/moe_mlp/wi"
    assert paths["blocks.2.mlp.fc1.weight"] == "blocks_2/mlp/fc1/kernel"
    back = flatten_tree(export_jax_params(model))
    for path, want in flatten_tree(params).items():
        np.testing.assert_array_equal(back[path], want, err_msg=path)


@pytest.mark.parametrize("flash", [False, True])
def test_vit_moe_logits_aux_and_gradients(vit_case, flash):
    """Train mode (no drop-path): logits to 1e-4, the summed auxiliary
    loss to 1e-5, and every gradient of CE + 0.01 aux to 1e-4 of the
    largest gradient of its leaf."""
    params, image = vit_case
    labels = np.arange(image.shape[0]) % 10
    jm = _jax_vit()

    def jloss(p):
        logits, muts = jm.apply({"params": p}, jnp.asarray(image), True,
                                mutable=["moe_losses"])
        aux = jax_moe.moe_aux_loss(muts)
        return JaxCELoss()(logits, jnp.asarray(labels)) + 0.01 * aux, (
            logits, aux)

    with jax_f32():
        (_, (jlogits, jaux)), jgrads = jax.value_and_grad(
            jloss, has_aux=True)(jax.tree.map(jnp.asarray, params))

    model = load_jax_params(ViTMoE(**TINY, dtype=torch.float32,
                                   use_flash_attention=flash), params)
    model.train()
    logits = model(torch.from_numpy(image))
    aux = moe.moe_aux_loss(model)
    (CELoss()(logits, torch.from_numpy(labels)) + 0.01 * aux).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    grads = flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))
    for path, want in flatten_tree(jgrads).items():
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(grads[path] - want).max() <= 1e-4 * scale + 1e-7, path
    router = grads["blocks_1/moe_mlp/router"]
    assert np.abs(router).sum() > 0


def test_gradient_checkpointing_keeps_the_aux_loss_and_gradients(vit_case):
    """Per-block gradient checkpointing (the layer recomputed in the
    backward) gives the same logits, auxiliary loss and gradients, the
    router's included, as the plain forward."""
    params, image = vit_case
    out = []
    for remat in (False, True):
        model = load_jax_params(ViTMoE(**TINY, dtype=torch.float32,
                                       use_gradient_checkpoint=remat),
                                params).train()
        logits = model(torch.from_numpy(image))
        aux = moe.moe_aux_loss(model)
        (logits.square().mean() + 0.01 * aux).backward()
        out.append((logits.detach(), aux.detach(),
                    {n: p.grad for n, p in model.named_parameters()}))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7,
                                   msg=n)


def test_engine_step_with_moe_aux_weight_matches_jax(vit_case):
    """One SGD step (momentum, weight decay) through both engines with the
    classification loss at moe_aux_weight 0.5: the loss to 1e-5, each
    parameter after the step to 1e-5."""
    params, image = vit_case
    batch = {"image": image,
             "label": (np.arange(image.shape[0]) % 10).astype(np.int32)}
    opt = dict(name="SGD", lr=0.05, weight_decay=1e-4, momentum=0.9)
    sched = dict(scheduler="CosineLR", lr=0.05, epochs=2)
    with jax_f32():
        jm = JaxViTMoE(**TINY)
        tx, _ = jax_optim.build_optimizer(
            jax_optim.OptimizerConfig(**opt),
            jax_schedule.SchedulerConfig(**sched), 2, params)
        jcfg = jax_engine.EngineConfig()
        jstate = jax_engine.create_train_state(
            jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
        jstep = jax_engine.make_train_step(
            jax_task.make_loss_fn(jm, JaxCELoss(), moe_aux_weight=0.5), tx,
            jcfg, donate=False)
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))

    from simpleaicv_tpu_torch.tasks import classification as port_task
    model = load_jax_params(ViTMoE(**TINY, dtype=torch.float32), params)
    popt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**sched), 2, model, device="cpu")
    pcfg = port_engine.EngineConfig()
    state = port_engine.create_train_state(model, popt, pcfg, device="cpu")
    step = port_engine.make_train_step(
        port_task.make_loss_fn(CELoss(), moe_aux_weight=0.5), pcfg)
    state, metrics = step(state, {"image": torch.from_numpy(image),
                                  "label": torch.from_numpy(batch["label"])})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    got = flatten_tree(export_jax_params(model))
    for path, want in flatten_tree(jax.tree.map(np.asarray,
                                                jstate.params)).items():
        np.testing.assert_allclose(got[path], want, rtol=1e-5, atol=1e-5,
                                   err_msg=path)


def test_trainer_passes_moe_aux_weight(tmp_path, vit_case):
    """A config's ``moe_aux_weight`` reaches the loss: the Trainer's first
    step's loss is CE + weight x aux on the same forward, at weight 7."""
    from simpleaicv_tpu_torch.tasks import classification as port_task
    seen = {}

    def make_loss_fn(criterion, **kw):
        seen.update(kw)
        return port_task.make_loss_fn(criterion, **kw)

    model = ViTMoE(**TINY, dtype=torch.float32)
    cfg = type("config", (), dict(
        network="tiny_vit_moe", model=model, num_classes=10, seed=0,
        input_image_size=32, train_criterion=CELoss(),
        train_dataset=FakeClassificationDataset(8, 32, 10),
        train_collater=ClassificationCollater(), batch_size=8,
        num_workers=1, epochs=1, print_interval=1, moe_aux_weight=7.0,
        optimizer=("SGD", {"lr": 0.01, "momentum": 0.9,
                           "weight_decay": 0.0}),
        scheduler=("CosineLR", {"warm_up_epochs": 0})))
    trainer = Trainer(cfg, str(tmp_path), make_loss_fn=make_loss_fn,
                      device="cpu")
    assert seen == {"moe_aux_weight": 7.0}
    batch = next(iter(trainer._device_prefetch(trainer.train_loader)))
    model.train()
    with torch.no_grad():
        ce = float(CELoss()(model(batch["image"]), batch["label"]))
        aux = float(moe.moe_aux_loss(model))
    _, metrics = trainer.train_step(trainer.state, batch, 0)
    assert aux > 0.5
    np.testing.assert_allclose(float(metrics["loss"]), ce + 7.0 * aux,
                               rtol=1e-5)


def test_macs_count_the_f32_output_expert_products():
    """``core/profile.compute_macs_and_params`` (the test CLI's MACs line)
    over ``torch.bmm(..., out_dtype=torch.float32)``, the expert products'
    route on the card, here on meta tensors: PyTorch's own formula took the
    dtype for the output shape and raised."""
    from torch import nn
    from simpleaicv_tpu_torch.core.profile import compute_macs_and_params

    class Product(nn.Module):
        def forward(self, a):
            b = torch.empty(2, 4, 5, device="meta", dtype=torch.bfloat16)
            return torch.bmm(a, b, out_dtype=torch.float32)

    a = torch.empty(2, 3, 4, device="meta", dtype=torch.bfloat16)
    macs, _ = compute_macs_and_params(Product(), a)
    assert macs == 2 * 3 * 4 * 5


def test_registered_sizes():
    for name, width, heads in (("vit_moe_tiny_patch16", 192, 3),
                               ("vit_moe_small_patch16", 384, 6),
                               ("vit_moe_base_patch16", 768, 12)):
        m = BACKBONES.create(name, num_classes=10, image_size=32,
                             num_experts=4)
        assert m.embedding_planes == width and m.head_nums == heads
        kinds = [type(b).__name__ for b in m.blocks]
        assert kinds[1] == kinds[11] == "MoETransformerEncoderLayer"
        assert kinds[0] == kinds[10] == "TransformerEncoderLayer"
        init_params(m, torch.Generator().manual_seed(0))
        assert m.blocks[1].moe_mlp.wi.shape == (4, width, 4 * width)
