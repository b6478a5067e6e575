"""The port's ConvFormer, VAN, DarkNet and CIFAR-ResNet backbones against
the JAX package's, in f32 on the CPU, from seeded weights and BatchNorm
statistics:

* each backbone in train mode (the logits, the new BatchNorm statistics
  and every gradient) and in eval mode, at reduced depths and widths
  through the model classes (ConvFormer and VAN: 1, 1, 2, 1 blocks of
  8 to 32 channels; DarkNet-tiny and ResNet18-CIFAR at their own widths;
  DarkNet-19, DarkNet-53 and ResNet50-CIFAR, the ``DEEP`` cases, in
  ``tests/test_torch_deep_cnn_backbones.py``);
* ``features_only`` of ConvFormer, VAN and DarkNet-53 in train mode;
* gradient checkpointing: the same gradients, the running statistics
  updated once, and the same drop-path masks replayed in the backward;
* DarkNet-tiny's zero pad before its last max pool (a ``-inf`` pad gives
  other logits after the LeakyReLU);
* the weights both ways, ``batch_stats`` included.

Tolerances, from readings on this box (``python
tests/test_torch_cnn_backbones.py`` with the repository and ``tests/`` on
``PYTHONPATH`` prints them): logits and features within 1e-4 of their
largest value (read: at most 1.2e-5), DarkNet-53's C3-C5 within 3e-3
(read: 4.5e-4); the statistics within 1e-5 (read: at most 3.6e-6),
DarkNet-53's within 1e-5 + 1e-3 of their value; each gradient leaf within
2e-3 of JAX's in L2 (read: at most 4.5e-4, ConvFormer's; train-mode
BatchNorm at batch 4 amplifies the f32 rounding of its statistics toward
the stem). The ``DEEP`` cases have their own bounds, set beside a witness:
the port's body in f64 from the same weights, from which JAX's own f32
gradients lie 6.0e-3 (DarkNet-19), 1.47e-2 (DarkNet-53) and 2.22e-2
(ResNet50-CIFAR) apart, where the port's f32 ones lie 6.2e-3, 1.47e-2 and
2.06e-2 from JAX's; their statistics read 2.9e-6 to 2.9e-5 apart, held
within 1e-5 + 1e-4 of their value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.models.backbones import convformer as jax_convformer
from simpleaicv_tpu.models.backbones import darknet as jax_darknet
from simpleaicv_tpu.models.backbones import van as jax_van
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.models.backbones import convformer, darknet, van

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

SMALL = dict(embedding_planes=(8, 16, 24, 32), block_nums=(1, 1, 2, 1))
VAN_SMALL = dict(SMALL, mlp_ratios=(2, 2, 2, 2))
CLASSES = 10
BATCH = 4

# name: (JAX model, port model, image size)
CASES = {
    "convformer": (lambda **kw: jax_convformer.MetaFormer(**SMALL, **kw),
                   lambda **kw: convformer.MetaFormer(**SMALL, **kw), 64),
    "van": (lambda **kw: jax_van.VAN(**VAN_SMALL, **kw),
            lambda **kw: van.VAN(**VAN_SMALL, **kw), 64),
    "darknettiny": (lambda **kw: JAX_BACKBONES.create("darknettiny", **kw),
                    lambda **kw: BACKBONES.create("darknettiny", **kw), 64),
    "darknet19": (lambda **kw: JAX_BACKBONES.create("darknet19", **kw),
                  lambda **kw: BACKBONES.create("darknet19", **kw), 64),
    "darknet53": (lambda **kw: JAX_BACKBONES.create("darknet53", **kw),
                  lambda **kw: BACKBONES.create("darknet53", **kw), 64),
    "resnet18cifar": (
        lambda **kw: JAX_BACKBONES.create("resnet18cifar", **kw),
        lambda **kw: BACKBONES.create("resnet18cifar", **kw), 16),
    "resnet50cifar": (
        lambda **kw: JAX_BACKBONES.create("resnet50cifar", **kw),
        lambda **kw: BACKBONES.create("resnet50cifar", **kw), 16),
}
# the deep networks end in train-mode BatchNorms over 2x2 maps at batch 4,
# which amplify f32 rounding: JAX's own f32 gradients lie as far from the
# port's f64 ones as from the port's f32 ones (the readings below); each
# case's (gradient bound, statistics' relative bound), default (2e-3, 0)
DEEP = {"darknet19": (2e-2, 0.0), "darknet53": (5e-2, 1e-4),
        "resnet50cifar": (6e-2, 1e-4)}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _image(size, seed=0):
    return np.random.RandomState(seed).randn(
        BATCH, size, size, 3).astype(np.float32)


def _variables(model, image, seed=1):
    with jax_f32():
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), True))
    return {"params": random_params(shapes["params"], seed=seed),
            "batch_stats": random_batch_stats(shapes["batch_stats"],
                                              seed=seed + 1)}


def _assert_close_to_scale(got, want, tol=1e-4):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _assert_trees_close(got, want, atol, rtol=0.0):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=atol, rtol=rtol,
                                   err_msg=path)


def _grad_errors(got, want):
    """Each leaf's L2 distance from JAX's over the larger of its own norm
    and 1e-4 of the largest leaf's: a convolution's bias before a
    train-mode BatchNorm has a true gradient of 0, and both sides give
    rounding noise there."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    top = max(np.linalg.norm(w) for w in want.values())
    return {path: float(np.linalg.norm(got[path] - w)
                        / max(np.linalg.norm(w), 1e-4 * top))
            for path, w in want.items()}


def _assert_grads_close(got, want, rel=2e-3):
    for path, err in _grad_errors(got, want).items():
        assert err <= rel, (path, err)


@pytest.fixture(scope="module", params=[n for n in CASES if n not in DEEP])
def case(request):
    return _jax_case(request.param)


def _jax_case(name):
    """(name, variables, image, head weights, JAX train logits, new
    batch_stats, gradients, eval logits)."""
    make_jax, _, size = CASES[name]
    model = make_jax(num_classes=CLASSES)
    image = _image(size)
    variables = _variables(model, image)
    w = np.random.RandomState(3).randn(BATCH, CLASSES).astype(np.float32)

    def loss(params, stats, x):
        out, new = model.apply({"params": params, "batch_stats": stats}, x,
                               True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, new["batch_stats"])

    with jax_f32():
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"],
                                 variables["batch_stats"], jnp.asarray(image))
        eval_out = jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, jnp.asarray(image))
    return (name, variables, image, w, np.asarray(out),
            jax.tree.map(np.asarray, stats), jax.tree.map(np.asarray, grads),
            np.asarray(eval_out))


def _port(name, variables, **kwargs):
    model = CASES[name][1](num_classes=CLASSES, dtype=torch.float32, **kwargs)
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


def _train_step(model, image, w, generator=None):
    model.train()
    out = model(torch.from_numpy(image), True, generator)
    (out * torch.from_numpy(w)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return out.detach().numpy(), export_jax_params(model, grads)


def test_train_mode_matches_jax(case):
    """The logits, the running statistics after one train-mode step and
    every gradient, also with gradient checkpointing (not in DarkNet,
    which has none in either package): recomputing the blocks does not
    update the statistics a second time."""
    name, variables, image, w, want, want_stats, want_grads, _ = case
    for remat in ((False,) if name.startswith("darknet") else (False, True)):
        kwargs = {"use_gradient_checkpoint": True} if remat else {}
        model = _port(name, variables, **kwargs)
        out, grads = _train_step(model, image, w)
        grad_rel, stats_rtol = DEEP.get(name, (2e-3, 0.0))
        _assert_close_to_scale(out, want)
        _assert_trees_close(export_jax_batch_stats(model), want_stats, 1e-5,
                            stats_rtol)
        _assert_grads_close(grads, want_grads, grad_rel)


def test_eval_mode_matches_jax(case):
    name, variables, image, _, _, _, _, want = case
    model = _port(name, variables).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(image))
    assert out.dtype == torch.float32 and out.shape == (BATCH, CLASSES)
    _assert_close_to_scale(out.numpy(), want)


def test_weights_carry_both_ways(case):
    name, variables, *_ = case
    model = _port(name, variables)
    _assert_trees_close(export_jax_params(model), variables["params"], 0)
    _assert_trees_close(export_jax_batch_stats(model),
                        variables["batch_stats"], 0)


def _features(name):
    """(port features, JAX features, port statistics, JAX statistics,
    ``feature_channels``) after one train-mode forward."""
    if name == "darknet53":
        jm = JAX_BACKBONES.create("darknet53", features_only=True)
        pm = BACKBONES.create("darknet53", features_only=True,
                              dtype=torch.float32)
        size = 32
    else:
        jm = CASES[name][0](features_only=True)
        pm = CASES[name][1](features_only=True, dtype=torch.float32)
        size = 64
    image = _image(size, seed=4)
    variables = _variables(jm, image, seed=5)
    with jax_f32():
        feats, new = jax.jit(lambda v, x: jm.apply(
            v, x, True, mutable=["batch_stats"]))(variables,
                                                  jnp.asarray(image))
    load_jax_params(pm, variables["params"],
                    batch_stats=variables["batch_stats"])
    with torch.no_grad():
        got = pm(torch.from_numpy(image), True)
    return ([g.numpy() for g in got], [np.asarray(f) for f in feats],
            export_jax_batch_stats(pm),
            jax.tree.map(np.asarray, new["batch_stats"]), pm.feature_channels)


@pytest.mark.parametrize("name", ["convformer", "van", "darknet53"])
def test_features_only_matches_jax(name):
    """The stages' outputs in train mode and the new statistics;
    ``feature_channels`` gives their widths. DarkNet-53's C5 at 32^2 is
    1x1: its train-mode BatchNorms normalise 4 values a channel, which
    amplifies the f32 rounding of 52 layers."""
    got, want, stats, want_stats, channels = _features(name)
    assert len(got) == len(want) == len(channels)
    deep = name == "darknet53"
    for g, f, c in zip(got, want, channels):
        assert g.shape[-1] == c
        _assert_close_to_scale(g, f, 3e-3 if deep else 1e-4)
    _assert_trees_close(stats, want_stats, 1e-5, 1e-3 if deep else 0.0)


@pytest.mark.parametrize("name", ["convformer", "van"])
def test_checkpointing_replays_the_drop_path_masks(name):
    """With drop path and dropout on, a checkpointed model's gradients
    equal the plain model's from the same generator state, and the
    generator ends where the plain run leaves it; the probabilities rise
    as ``i / max(total - 1, 1)``."""
    image = _image(64, seed=6)
    w = np.random.RandomState(7).randn(BATCH, CLASSES).astype(np.float32)
    runs = []
    for remat in (False, True):
        model = CASES[name][1](num_classes=CLASSES, dtype=torch.float32,
                               drop_path_prob=0.3, dropout_prob=0.2,
                               use_gradient_checkpoint=remat)
        from simpleaicv_tpu_torch.models.common import init_params
        init_params(model, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(11)
        out, grads = _train_step(model, image, w, gen)
        runs.append((out, flatten_tree(grads), gen.get_state()))
        probs = [blk.drop_path_prob for blk in (
            model.stages if name == "convformer" else
            [model.block1, model.block2, model.block3, model.block4])
            for blk in blk]
        total = len(probs)
        assert probs == pytest.approx([0.3 * i / (total - 1)
                                       for i in range(total)])
    (out0, g0, s0), (out1, g1, s1) = runs
    np.testing.assert_array_equal(out0, out1)
    assert torch.equal(s0, s1)
    for path in g0:
        np.testing.assert_allclose(g1[path], g0[path], rtol=1e-6, atol=1e-7,
                                   err_msg=path)


def test_darknet_tiny_pads_with_zeros_before_its_last_pool():
    """A channel that is negative everywhere after conv6's LeakyReLU takes
    the pad's 0 at the bottom and right edges, as in JAX; a ``-inf`` pad
    (``max_pool2d(padding=)``) would keep the negative values."""
    x = -torch.rand(1, 3, 3, 2) - 0.5
    padded = darknet._max_pool(F.pad(x, (0, 0, 0, 1, 0, 1), value=0.0), 1)
    assert padded.shape == x.shape
    assert (padded[:, -1] == 0).all() and (padded[:, :, -1] == 0).all()
    assert (padded[:, :2, :2] < 0).all()
    assert jnp.array_equal(
        jax_darknet.nn.max_pool(jnp.pad(jnp.asarray(x.numpy()),
                                        ((0, 0), (0, 1), (0, 1), (0, 0))),
                                (2, 2), strides=(1, 1)),
        padded.numpy())


if __name__ == "__main__":
    # the readings behind the tolerances: run with the repository and
    # tests/ on PYTHONPATH
    torch.backends.mkldnn.flags(enabled=False).__enter__()
    for name in CASES:
        _, variables, image, w, want, want_stats, want_grads, want_eval = \
            _jax_case(name)
        for remat in ((False,) if name.startswith("darknet") else (False, True)):
            kwargs = {"use_gradient_checkpoint": True} if remat else {}
            model = _port(name, variables, **kwargs)
            out, grads = _train_step(model, image, w)
            stats = flatten_tree(export_jax_batch_stats(model))
            ws = flatten_tree(want_stats)
            print(name, "remat" if remat else "plain",
                  "logits", np.abs(out - want).max() / np.abs(want).max(),
                  "stats", max(np.abs(stats[k] - ws[k]).max() for k in ws),
                  "relative", max((np.abs(stats[k] - ws[k])
                                   / (1e-5 + np.abs(ws[k]))).max()
                                  for k in ws),
                  "grads", max(_grad_errors(grads, want_grads).values()))
        # the witness: the port's body in f64 from the same weights
        model = CASES[name][1](num_classes=CLASSES, dtype=torch.float64)
        model = load_jax_params(model, variables["params"],
                                batch_stats=variables["batch_stats"]).double()
        model.train()
        out = model(torch.from_numpy(image).double(), True)
        (out * torch.from_numpy(w).double()).sum().backward()
        exact = export_jax_params(model, {k: p.grad for k, p
                                          in model.named_parameters()})
        _, grads = _train_step(_port(name, variables), image, w)
        print(name, "from f64: JAX's f32 grads",
              max(_grad_errors(want_grads, exact).values()), "the port's",
              max(_grad_errors(grads, exact).values()))
    for name in ("convformer", "van", "darknet53"):
        got, want, stats, want_stats, _ = _features(name)
        ws = flatten_tree(want_stats)
        stats = flatten_tree(stats)
        print(name, "features", max(np.abs(g - f).max() / np.abs(f).max()
                                    for g, f in zip(got, want)),
              "stats", max(np.abs(stats[k] - ws[k]).max() for k in ws),
              "relative", max((np.abs(stats[k] - ws[k])
                               / (1e-5 + np.abs(ws[k]))).max() for k in ws))
