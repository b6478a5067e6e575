"""The port's Sapiens parsing model and its two new layers against the JAX
package's, in f32 on the CPU: flax's ``InstanceNorm`` and the 4x4
stride-2 ``ConvTranspose`` (padding ((2, 2), (2, 2)): exactly twice the
input's size, odd and even), then ``SapiensParsing`` on a tiny backbone
(``_torch_port.TINY_SAPIENS``) on bridged weights: logits, parameter
gradients and one engine step of the CelebAMask-HQ recipe (SegCombinedLoss,
AdamW, CosineLR); gradient checkpointing with dropout, and the registered
widths of the full models."""

import flax.linen as fnn
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
from simpleaicv_tpu.models.sapiens_parsing import \
    SapiensParsing as JaxSapiens
from simpleaicv_tpu.tasks import semantic_segmentation as jax_seg
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.models.common import ConvTranspose2d, InstanceNorm
from simpleaicv_tpu_torch.models.sapiens_parsing import SapiensParsing
from simpleaicv_tpu_torch.tasks import semantic_segmentation as port_seg

from _torch_port import (TINY_SAPIENS, assert_updates_agree, flatten_tree,
                         jax_f32, one_torch_thread, random_params,
                         register_tiny_sapiens)

IMG, CLASSES = 64, 5


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    register_tiny_sapiens()
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- InstanceNorm and the transposed convolution ----------------------------

def test_instance_norm_matches_flax():
    """Per sample and channel over H and W, biased variance, eps 1e-5 under
    the root: values within 1e-5 on channels whose means are up to 3 times
    their spread (flax's unshifted ``E[x^2] - E[x]^2`` loses digits as
    the mean grows, on either side), input gradients within 1e-4 of their
    largest."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 7, 6) + 1.5 * rng.randn(1, 1, 1, 6)).astype(
        np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    norm = fnn.InstanceNorm(epsilon=1e-5, use_bias=False, use_scale=False)
    variables = norm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert variables == {}
    want = np.asarray(norm.apply({}, jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(
        norm.apply({}, v) * w))(jnp.asarray(x)))
    tx = _t(x).requires_grad_()
    got = InstanceNorm()(tx)
    (got * _t(w)).sum().backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), want_grad,
                               atol=1e-4 * np.abs(want_grad).max())
    assert not list(InstanceNorm().parameters())


class _Holder(torch.nn.Module):
    """A transposed convolution under a name the weight bridge knows."""

    def __init__(self, layer):
        super().__init__()
        self.convt1 = layer


@pytest.mark.parametrize("hw", [(5, 5), (8, 8), (5, 6)],
                         ids=["odd", "even", "mixed"])
@pytest.mark.parametrize("bias", [False, True])
def test_conv_transpose_k4_s2_matches_flax(hw, bias):
    """flax ``ConvTranspose((4, 4), strides 2, padding ((2, 2), (2, 2)))``
    and the port's ``ConvTranspose2d(4, 2, padding=1)`` on the bridged
    (spatially flipped) kernel: exactly (2H, 2W), values and gradients of
    the input and the kernel within 1e-5 of their largest."""
    h, w = hw
    rng = np.random.RandomState(1)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    layer = fnn.ConvTranspose(4, (4, 4), strides=(2, 2),
                              padding=((2, 2), (2, 2)), use_bias=bias)
    shapes = jax.eval_shape(layer.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = random_params(shapes["params"], 2)
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    assert want.shape == (2, 2 * h, 2 * w, 4)
    g = rng.randn(*want.shape).astype(np.float32)
    want_gx, want_gp = jax.grad(lambda v, p: jnp.sum(
        layer.apply({"params": p}, v) * g), argnums=(0, 1))(
        jnp.asarray(x), params)

    port = _Holder(ConvTranspose2d(3, 4, 4, 2, padding=1, bias=bias))
    load_jax_params(port, {"convt1": params})
    tx = _t(x).requires_grad_()
    got = port.convt1(tx)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    (got * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx),
                               atol=1e-5 * np.abs(np.asarray(want_gx)).max())
    got_gp = flatten_tree(export_jax_params(
        port, {n: p.grad for n, p in port.named_parameters()}))
    for path, want_leaf in flatten_tree({"convt1": want_gp}).items():
        np.testing.assert_allclose(got_gp[path], want_leaf,
                                   atol=1e-5 * np.abs(want_leaf).max(),
                                   err_msg=path)


# ---- SapiensParsing ---------------------------------------------------------

def _image(seed=0, n=2):
    return np.random.RandomState(seed).rand(n, IMG, IMG, 3).astype(
        np.float32) * 2 - 1


def _pair(seed=1, **kwargs):
    """(JAX model, its seeded params, the port's model loaded with them)."""
    kwargs = dict(TINY_SAPIENS, num_classes=CLASSES, image_size=IMG, **kwargs)
    with jax_f32():
        jm = JaxSapiens(**kwargs)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, IMG, IMG, 3)))
    params = random_params(shapes["params"], seed)
    pm = SapiensParsing(dtype=torch.float32, **kwargs)
    return jm, params, load_jax_params(pm, params)


def test_logits_and_gradients_match_jax():
    """Eval-mode logits within 1e-5 of their largest (train mode, with no
    dropout, the same); parameter gradients of sum(logits * weights) within
    1e-4 of each leaf's largest (or of a thousandth of the largest leaf's):
    the eight InstanceNorms divide by each map's deviation, as BatchNorm
    in train mode does."""
    jm, params, pm = _pair()
    x = _image()
    with jax_f32():
        want = np.asarray(jax.jit(lambda p, v: jm.apply(
            {"params": p}, v, False))(params, x))
        w = np.random.RandomState(3).randn(*want.shape).astype(np.float32)
        want_grads = flatten_tree(jax.tree.map(np.asarray, jax.jit(
            jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, x, True)
                                       * w)))(params)))
    assert want.shape == (2, IMG, IMG, CLASSES)
    with torch.no_grad():
        got = pm.eval()(_t(x))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale)
    out = pm.train()(_t(x))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5 * scale)
    (out * _t(w)).sum().backward()
    got_grads = flatten_tree(export_jax_params(
        pm, {n: p.grad for n, p in pm.named_parameters()}))
    assert set(got_grads) == set(want_grads)
    floor = 1e-3 * max(np.abs(v).max() for v in want_grads.values())
    for path, v in want_grads.items():
        err = np.abs(got_grads[path] - v).max()
        assert err <= 1e-4 * max(np.abs(v).max(), floor), (path, err)
    assert all(not b.attn.use_flash_attention for b in pm.blocks)


def test_one_engine_step_tracks_jax():
    """The CelebAMask-HQ recipe's loss (SegCELoss + softmax SegIoULoss,
    255 ignored), AdamW and CosineLR (its 1-epoch warm-up cut, so that the
    first step moves), one step on two images with ignored pixels: the
    loss within 1e-4 relative and the parameter changes as
    ``_torch_port.assert_updates_agree`` holds them."""
    opt = dict(name="AdamW", lr=1e-4, weight_decay=1e-3,
               global_weight_decay=False, no_weight_decay_layer_name_list=())
    sched = dict(scheduler="CosineLR", lr=1e-4, epochs=2, warm_up_epochs=0,
                 min_lr=1e-6)
    loss_cfg = [("SegCELoss", 1.0, {"ignore_index": 255}),
                ("SegIoULoss", 1.0, {"logit_type": "softmax",
                                     "ignore_index": 255})]
    rng = np.random.RandomState(4)
    mask = rng.randint(0, CLASSES, (2, IMG, IMG)).astype(np.int32)
    mask[:, -6:] = 255
    batch = {"image": _image(5), "mask": mask}
    jm, params, pm = _pair(seed=6)
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**opt),
        jax_schedule.SchedulerConfig(**sched), 2, params)
    jcfg = jax_engine.EngineConfig()
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
    with jax_f32():
        jstep = jax_engine.make_train_step(
            jax_seg.make_loss_fn(jm, JAX_LOSSES.create(
                "SegCombinedLoss", loss_cfg=loss_cfg)), tx, jcfg,
            donate=False)
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))
    optimizer, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**sched), 2, pm, device="cpu")
    state = port_engine.create_train_state(
        pm, optimizer, port_engine.EngineConfig(), device="cpu")
    step = port_engine.make_train_step(
        port_seg.make_loss_fn(LOSSES.create("SegCombinedLoss",
                                            loss_cfg=loss_cfg)),
        port_engine.EngineConfig())
    state, metrics = step(state, {k: _t(v) for k, v in batch.items()})
    assert float(metrics["skipped"]) == float(jmetrics["skipped"]) == 0.0
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=1e-4)
    assert_updates_agree(export_jax_params(pm), jstate.params, params, opt)


def test_gradient_checkpointing_replays_the_dropout():
    """With dropout after the position encoding, a checkpointed model gives
    the logits and gradients of the plain one from the same generator seed,
    and leaves the generator where the plain one does."""
    _, params, plain = _pair(dropout_prob=0.2)
    _, _, ckpt = _pair(dropout_prob=0.2, use_gradient_checkpoint=True)
    x = _image()
    results = []
    for model in (plain, ckpt):
        gen = torch.Generator().manual_seed(7)
        out = model.train()(_t(x), generator=gen)
        out.square().mean().backward()
        results.append((out.detach(), {n: p.grad for n, p in
                                       model.named_parameters()},
                        gen.get_state()))
    (o1, g1, s1), (o2, g2, s2) = results
    assert torch.equal(o1, o2) and torch.equal(s1, s2)
    for name, g in g1.items():
        torch.testing.assert_close(g2[name], g, rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        evaluated = plain.eval()(_t(x))
    assert not torch.equal(evaluated, o1)   # the dropout applied in train


@pytest.mark.parametrize("name", ["sapiens_0_3b_face_parsing",
                                  "sapiens_1_0b_human_parsing"])
def test_registered_models_have_the_jax_tree(name):
    """The full models, built on the meta device: the same parameter paths
    and sizes as the JAX model's tree at 512^2, 19 classes."""
    with jax_f32():
        shapes = jax.eval_shape(
            JAX_MODELS.create(name, num_classes=19, image_size=512).init,
            jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
    want = {p: int(np.prod(a.shape)) for p, a in _leaf_shapes(
        shapes["params"]).items()}
    with torch.device("meta"):
        model = MODELS.create(name, num_classes=19, image_size=512)
    paths = jax_paths(model)
    state = model.state_dict()
    got = {paths[k]: v.numel() for k, v in state.items()}
    assert got == want
    for name_ in ("sapiens_0_3b_face_parsing", "sapiens_0_6b_face_parsing",
                  "sapiens_1_0b_face_parsing", "sapiens_0_3b_human_parsing",
                  "sapiens_0_6b_human_parsing", "sapiens_1_0b_human_parsing"):
        assert name_ in MODELS


def _leaf_shapes(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(val, "items"):
            out.update(_leaf_shapes(val, path))
        else:
            out[path] = val
    return out
