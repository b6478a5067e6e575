"""The port's ResNet backbones and BatchNorm against the JAX package's, in f32
on the CPU: ``features_only`` C2-C5 of ResNet-18 and ResNet-50 in train mode
(outputs and the updated running statistics against
``mutable=["batch_stats"]``) and in eval mode, with gradient checkpointing,
the classifier head, and the weights both ways, ``batch_stats`` included."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.ops.fused_bn import FusedBatchNorm as JaxBatchNorm
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.ops.fused_bn import FusedBatchNorm

from _torch_port import (flatten_tree, jax_f32, random_batch_stats,
                         random_params)

IMG = 128


def _assert_close_to_scale(got, want, tol=1e-4):
    """max |got - want| within ``tol`` of want's largest value."""
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _assert_trees_close(got, want, atol, rtol=0.0):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=atol, rtol=rtol,
                                   err_msg=path)


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def resnet(request):
    """(name, JAX model, variables, image, JAX train outputs and new
    batch_stats, JAX eval outputs), from seeded weights and statistics."""
    name = request.param
    image = np.random.RandomState(0).randn(2, IMG, IMG, 3).astype(np.float32)
    with jax_f32():
        model = JAX_BACKBONES.create(name, features_only=True)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), True))
        variables = {"params": random_params(shapes["params"], seed=1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], seed=2)}
        train = jax.jit(lambda v, x: model.apply(
            v, x, True, mutable=["batch_stats"]))
        evaluate = jax.jit(lambda v, x: model.apply(v, x, False))
        feats, new_vars = train(variables, jnp.asarray(image))
        eval_feats = evaluate(variables, jnp.asarray(image))
    return (name, variables, image, [np.asarray(f) for f in feats],
            jax.tree.map(np.asarray, new_vars["batch_stats"]),
            [np.asarray(f) for f in eval_feats])


def _port(name, variables, **kwargs):
    model = BACKBONES.create(name, features_only=True, dtype=torch.float32,
                             **kwargs)
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


@pytest.mark.parametrize("checkpointed", [False, True])
def test_train_mode_matches_jax(resnet, checkpointed):
    """Batch statistics, the features and the running statistics after one
    train-mode forward; recomputing the blocks in the backward does not
    update the running statistics a second time."""
    name, variables, image, want, want_stats, _ = resnet
    model = _port(name, variables, use_gradient_checkpoint=checkpointed)
    x = torch.from_numpy(image).requires_grad_()
    feats = model(x, True)
    assert len(feats) == 4 and model.feature_channels == [
        f.shape[-1] for f in want]
    # train-mode BatchNorm divides by batch deviations that are a few times
    # smaller than the means at depth, and the f32 rounding of the two sides'
    # sums grows with it: the port in f32 and in f64 part by 3.5e-4 of the
    # largest value at ResNet-50's C5 at 64^2, the port and JAX by 8e-4
    for got, w in zip(feats, want):
        _assert_close_to_scale(got.detach().numpy(), w, tol=2e-3)
    sum(f.square().sum() for f in feats).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    # the variances carry the same rounding of the batch sums: 1e-4
    _assert_trees_close(export_jax_batch_stats(model), want_stats, atol=1e-4,
                        rtol=1e-4)


def test_eval_mode_matches_jax(resnet):
    name, variables, image, _, _, want = resnet
    model = _port(name, variables)
    before = export_jax_batch_stats(model)
    with torch.no_grad():
        feats = model(torch.from_numpy(image), False)
    for got, w in zip(feats, want):
        _assert_close_to_scale(got.numpy(), w)
    _assert_trees_close(export_jax_batch_stats(model), before, atol=0.0)


def test_weights_round_trip(resnet):
    """JAX tree -> port -> JAX tree gives the same leaves, parameters and
    batch_stats each in their own tree; a leaf left over raises."""
    name, variables, _, _, _, _ = resnet
    model = _port(name, variables)
    _assert_trees_close(export_jax_params(model), variables["params"],
                        atol=0.0)
    _assert_trees_close(export_jax_batch_stats(model),
                        variables["batch_stats"], atol=0.0)
    with pytest.raises(KeyError, match="batch_stats:stem/bn/mean"):
        load_jax_params(BACKBONES.create(name, features_only=True),
                        variables["params"])
    extra = dict(variables["params"], stray={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_params(BACKBONES.create(name, features_only=True), extra,
                        batch_stats=variables["batch_stats"])


def test_classifier_head_matches_jax():
    image = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    with jax_f32():
        model = JAX_BACKBONES.create("resnet18", num_classes=10)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), False))
        variables = {"params": random_params(shapes["params"], seed=4),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], seed=5)}
        want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, jnp.asarray(image)))
    port = load_jax_params(
        BACKBONES.create("resnet18", num_classes=10, dtype=torch.float32),
        variables["params"], batch_stats=variables["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(image), False)
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shift_scale", [0.0, 100.0])
def test_batchnorm_forward_and_gradients_match_jax(shift_scale):
    """FusedBatchNorm in train mode, NHWC, a large channel mean (where the
    shifted statistics matter): output, input and parameter gradients, and
    the running statistics (unbiased variance, momentum 0.9)."""
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 5, 3, 4) + shift_scale).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.randn(4)).astype(np.float32),
              "bias": (0.1 * rng.randn(4)).astype(np.float32)}
    stats = {"mean": np.full(4, shift_scale, np.float32) + 0.5,
             "var": (0.5 + rng.rand(4)).astype(np.float32)}
    bn = JaxBatchNorm(use_running_average=None)

    def f(p, xx):
        y, new = bn.apply({"params": p, "batch_stats": stats}, xx,
                          use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, new["batch_stats"])

    (_, (want_y, want_stats)), (want_dp, want_dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    port = FusedBatchNorm(4)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["scale"]))
        port.bias.copy_(torch.from_numpy(params["bias"]))
        port.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt, True)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(want_dp["scale"]), atol=1e-4)
    np.testing.assert_allclose(port.bias.grad.numpy(),
                               np.asarray(want_dp["bias"]), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(want_stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(want_stats["var"]), rtol=1e-5)
    # eval mode: the centred form with the running statistics
    want_eval = bn.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        port.running_mean.copy_(torch.from_numpy(stats["mean"]))
        port.running_var.copy_(torch.from_numpy(stats["var"]))
        got = port(torch.from_numpy(x), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_eval),
                               atol=1e-5)
