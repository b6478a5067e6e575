"""The port's DeepLabV3+ and PFAN models against the JAX package's, in f32
on the CPU, on seeded weights and BatchNorm statistics carried across by
``core.weights``: outputs in eval and train mode, the running statistics
after one train-mode forward (where flax BatchNorm's biased variance
shows), parameter gradients, and the weight bridge both ways."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.models.common import BatchNorm
from simpleaicv_tpu_torch.ops.fused_bn import FusedBatchNorm

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

IMG = 64
# name -> (kwargs, the number of outputs); DeepLabV3+ 32 wide
MODEL_CASES = {
    "resnet18_deeplabv3plus": (dict(num_classes=5, planes=32), 1),
    "resnet18_pfan_segmentation": ({}, 1),
    "resnet18_pfan_face_parsing": (dict(num_classes=4), 1),
    "resnet18_pfan_matting": ({}, 3),
}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """oneDNN's f32 convolution backward parts from an f64 reference by
    several percent of a small layer's weight gradient on this CPU
    (``tests/test_torch_trainer.py``); PyTorch's native kernels do not."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def case(request):
    return jax_case(request.param)


def jax_case(name):
    """(name, kwargs, variables, image, output weights, JAX eval outputs,
    JAX train outputs, JAX batch_stats after them, JAX parameter
    gradients of sum(outputs * weights) in train mode, the same through the
    running statistics)."""
    kwargs, n_out = MODEL_CASES[name]
    rng = np.random.RandomState(0)
    # a colour shift per image, so that the images' global means (the ASPP
    # pooling branch, normalised over the batch) differ well beyond rounding
    image = (rng.rand(2, IMG, IMG, 3) + rng.randn(2, 1, 1, 3)).astype(
        np.float32)
    with jax_f32():
        model = JAX_MODELS.create(name, **kwargs)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), False))
        variables = {"params": random_params(shapes["params"], seed=1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], seed=2)}
        out_shapes = _outputs(jax.eval_shape(
            lambda: model.apply(variables, jnp.asarray(image), False)))
        weights = [rng.randn(*o.shape).astype(np.float32)
                   for o in out_shapes]
        assert len(weights) == n_out

        def loss(params, x, train):
            v = {"params": params, "batch_stats": variables["batch_stats"]}
            if train:
                out, new = model.apply(v, x, True, mutable=["batch_stats"])
            else:
                out, new = model.apply(v, x, False), {"batch_stats": {}}
            total = sum(jnp.sum(o * w) for o, w in zip(_outputs(out),
                                                       weights))
            return total, (out, new["batch_stats"])

        grad = jax.grad(loss, has_aux=True)
        eval_grads, (eval_out, _) = jax.jit(
            lambda p, x: grad(p, x, False))(variables["params"], image)
        grads, (train_out, stats) = jax.jit(
            lambda p, x: grad(p, x, True))(variables["params"], image)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (name, kwargs, variables, image, weights,
            [np.asarray(o) for o in _outputs(eval_out)],
            [np.asarray(o) for o in _outputs(train_out)], as_np(stats),
            as_np(grads), as_np(eval_grads))


def _port(name, kwargs, variables):
    model = MODELS.create(name, dtype=torch.float32, **kwargs)
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


def _close_to_scale(got, want, tol):
    """max |got - want| within ``tol`` of want's largest value."""
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (err,
                                                          np.abs(want).max())


def test_eval_mode_matches_jax(case):
    name, kwargs, variables, image, _, want, _, _, _, _ = case
    model = _port(name, kwargs, variables).eval()
    with torch.no_grad():
        got = _outputs(model(torch.from_numpy(image)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


def test_train_mode_outputs_and_running_statistics_match_jax(case):
    """One train-mode forward: the outputs, and every running mean and
    variance, flax BatchNorm's (biased variance) and the backbone's
    (unbiased) alike."""
    name, kwargs, variables, image, _, _, want, want_stats, _, _ = case
    model = _port(name, kwargs, variables).train()
    with torch.no_grad():
        got = _outputs(model(torch.from_numpy(image)))
    # train-mode BatchNorm divides by batch deviations, and the two sides'
    # f32 rounding of the batch sums grows through the layers: DeepLabV3+'s
    # logits part by 4.4e-4 of their largest value (the ASPP pooling
    # branch normalises over 2 values), PFAN's by under 3e-5
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), w, 2e-3)
    got_stats = flatten_tree(export_jax_batch_stats(model))
    want_stats = flatten_tree(want_stats)
    assert set(got_stats) == set(want_stats)
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, atol=1e-4, rtol=1e-4,
                                   err_msg=path)


def test_flax_batchnorm_blends_the_biased_variance():
    """The head's BatchNorm: the running variance after one step is 0.9 *
    1 + 0.1 * the biased batch variance, where the backbone's blends the
    unbiased one; both normalise by the biased one."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 3, 4).astype(
        np.float32) * 2 + 1)
    flat = x.reshape(-1, 4).double()
    biased, unbiased = flat.var(0, unbiased=False), flat.var(0)
    flax_bn, fused_bn = BatchNorm(4), FusedBatchNorm(4)
    for bn in (flax_bn, fused_bn):
        bn.reset_parameters(None)
        y = bn(x, True)
        np.testing.assert_allclose(
            y.detach().double().reshape(-1, 4).var(
                0, unbiased=False).numpy(),
            (biased / (biased + 1e-5)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(flax_bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    np.testing.assert_allclose(fused_bn.running_var.numpy(),
                               (0.9 + 0.1 * unbiased).numpy(), rtol=1e-6)


def _port_gradients(name, kwargs, variables, image, weights, train):
    model = _port(name, kwargs, variables)
    out = _outputs(model(torch.from_numpy(image), train))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, weights)
        ).backward()
    return flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))


def test_eval_mode_gradients_match_jax(case):
    """Gradients of sum(outputs * weights) through the running statistics:
    every leaf within 1e-4 of its largest value (or of a thousandth of the
    largest leaf's), the resizes', depthwise and transposed convolutions'
    backward included."""
    name, kwargs, variables, image, weights, _, _, _, _, want = case
    want = flatten_tree(want)
    got = _port_gradients(name, kwargs, variables, image, weights, False)
    assert set(got) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), floor), (path, err)


def test_train_mode_gradients_match_jax(case):
    """Gradients of sum(outputs * weights) through the batch statistics,
    leaf by leaf in L2 (within 5% of the leaf's norm, or of a thousandth of
    the largest leaf's) and by cosine (above 0.999). Train-mode BatchNorm
    amplifies f32 rounding here: at DeepLabV3+'s C1 ASPP the JAX gradients
    part from an f64 run of the port by up to 10.6% of a leaf's largest
    value, the port's f32 ones by 1.5%; PFAN's by 3.2% and 1e-5."""
    name, kwargs, variables, image, weights, _, _, _, want, _ = case
    got = _port_gradients(name, kwargs, variables, image, weights, True)
    want = flatten_tree(want)
    assert set(got) == set(want)
    floor = 1e-3 * max(np.linalg.norm(w) for w in want.values())
    for path, w in want.items():
        g = got[path]
        norm = np.linalg.norm(w)
        assert np.linalg.norm(g - w) <= 0.05 * max(norm, floor), path
        if norm > floor:
            cos = np.dot(g.ravel(), w.ravel()) / (np.linalg.norm(g) * norm)
            assert cos > 0.999, (path, cos)


def test_weights_round_trip(case):
    """JAX tree -> port -> JAX tree gives the same leaves (depthwise and
    transposed kernels included); a leaf left over raises either way."""
    name, kwargs, variables, _, _, _, _, _, _, _ = case
    model = _port(name, kwargs, variables)
    for got, want in ((export_jax_params(model), variables["params"]),
                      (export_jax_batch_stats(model),
                       variables["batch_stats"])):
        got, want = flatten_tree(got), flatten_tree(want)
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    extra = dict(variables["params"], stray={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_params(MODELS.create(name, **kwargs), extra,
                        batch_stats=variables["batch_stats"])
    tensors = dict(model.state_dict(), stray=torch.zeros(1))
    with pytest.raises(ValueError, match="no port parameter"):
        export_jax_params(model, tensors)


def test_registry_names():
    """ResNet variants are registered, and the VAN and ConvFormer ones build
    on their backbones (their trees:
    ``tests/test_torch_backbone_variants.py``)."""
    for bb in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152"):
        assert f"{bb}_deeplabv3plus" in MODELS
        for task in ("segmentation", "matting", "face_parsing",
                     "human_parsing"):
            assert f"{bb}_pfan_{task}" in MODELS
    for name, bb in (("vanb2_deeplabv3plus", "VAN"),
                     ("convformerm36_deeplabv3plus", "MetaFormer"),
                     ("vanb2_pfan_segmentation", "VAN")):
        with torch.device("meta"):
            assert type(MODELS.create(name).backbone).__name__ == bb
