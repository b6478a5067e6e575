"""The port's InceptionV3 and FID/IS against the JAX package's, in f32 on the
CPU: both variants (torchvision and FID) at 96^2 without the 299 resize, on
seeded JAX weights and BatchNorm statistics carried across by
``core.weights``; the weight bridge the other way, the port's
``state_dict`` (torchvision's key names) through the JAX package's
``convert_official_state_dict(sd, "inception_v3")`` and ``apply_converted``
into the JAX model; the 299 resize alone against ``jax.image.resize(...,
antialias=False)``; the feature function on a weights file; and the FID
and IS arithmetic.

Tolerances: features, logits and resized images within 1e-5 of their
largest value; FID and IS within 1e-6 relative (both sides' numpy and
scipy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.converters import (apply_converted,
                                            convert_official_state_dict)
from simpleaicv_tpu.evaluation import fid_is as jax_fid
from simpleaicv_tpu.models.inception_v3 import InceptionV3 as JaxInception
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.evaluation import fid_is
from simpleaicv_tpu_torch.models.inception_v3 import InceptionV3

from _torch_port import (flatten_tree, one_torch_thread, random_batch_stats,
                         random_params)

SIDE = 96


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.fixture(scope="module", params=[False, True], ids=["torchvision",
                                                           "fid"])
def case(request):
    """(fid, the jitted JAX apply of variables and images, the variables,
    the images in [-1, 1], JAX's (pool, logits))."""
    fid = request.param
    model = JaxInception(fid=fid)
    images = np.random.RandomState(0).uniform(
        -1, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.asarray(images), False))
    variables = {"params": random_params(shapes["params"], 1),
                 "batch_stats": random_batch_stats(shapes["batch_stats"], 2)}
    apply = jax.jit(lambda v, x: model.apply(v, x, False))
    return fid, apply, variables, images, apply(variables, images)


def _port(fid, variables):
    return load_jax_params(InceptionV3(fid=fid), variables["params"],
                           batch_stats=variables["batch_stats"]).eval()


def test_inception_on_jax_weights(case):
    """pool3 features and logits of both variants (the FID one's average
    pools divide by the cells under the window, its Mixed_7c pool is a
    max, its classifier 1008-way without bias)."""
    fid, _, variables, images, (pool, logits) = case
    model = _port(fid, variables)
    assert model.fc.weight.shape[0] == (1008 if fid else 1000)
    assert (model.fc.bias is None) == fid
    with torch.no_grad():
        got_pool, got_logits = model(torch.from_numpy(images))
    _close(got_pool, pool)
    _close(got_logits, logits)
    for tree, back in ((variables["params"], export_jax_params(model)),
                       (variables["batch_stats"],
                        export_jax_batch_stats(model))):
        assert set(flatten_tree(back)) == set(flatten_tree(tree))


def test_state_dict_through_the_jax_converter(case):
    """The port's ``state_dict`` as a torchvision checkpoint: every tensor
    lands in the JAX tree through ``convert_official_state_dict`` and
    ``apply_converted``, and the JAX model on it gives the port's
    features."""
    fid, apply, variables, images, _ = case
    model = _port(fid, variables)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    zeros = jax.tree.map(np.zeros_like, variables)
    converted, n = apply_converted(
        zeros, convert_official_state_dict(sd, "inception_v3"))
    assert n == len(sd)
    pool, logits = apply(converted, images)
    with torch.no_grad():
        got_pool, got_logits = model(torch.from_numpy(images))
    _close(got_pool, pool)
    _close(got_logits, logits)


def test_torchvision_state_dict_loads_with_its_counters():
    """A torchvision-style state dict (with ``num_batches_tracked``)
    loads strictly."""
    model = InceptionV3(fid=True)
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    sd["Mixed_5b.branch1x1.bn.num_batches_tracked"] = torch.tensor(3)
    model.load_state_dict(sd)
    assert not model.Mixed_5b.branch1x1.bn.running_mean.any()


@pytest.mark.parametrize("side", [64, 400])
def test_resize_to_299_matches_jax(side):
    """Up (64) and down (400: no antialiasing on either side)."""
    images = np.random.RandomState(side).rand(2, side, side, 3).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(images), (2, 299, 299, 3),
                            "bilinear", antialias=False)
    _close(fid_is.resize_to_inception(torch.from_numpy(images)), want)


def test_feature_fn_on_a_weights_file(case, tmp_path):
    """The feature function (resize off, [0, 1] inputs scaled to [-1, 1])
    on a ``torch.save``d state dict under 'state_dict' gives the JAX
    model's pool3 features and softmax; a file that lacks a tensor is
    refused."""
    fid, _, variables, images, (pool, logits) = case
    model = _port(fid, variables)
    path = str(tmp_path / "inception.pth")
    torch.save({"state_dict": model.state_dict()}, path)
    feature_fn = fid_is.make_inception_feature_fn(
        path, fid_variant=fid, resize_input=False, device="cpu")
    got_pool, got_probs = feature_fn((images + 1.0) / 2.0)
    _close(got_pool, pool)
    _close(got_probs, jax.nn.softmax(logits, -1))
    partial = dict(model.state_dict())
    partial.pop("fc.weight")
    torch.save(partial, path)
    with pytest.raises(ValueError, match="loaded"):
        fid_is.make_inception_feature_fn(path, fid_variant=fid,
                                         device="cpu")


def test_feature_fn_needs_a_card_by_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid_is.make_inception_feature_fn()


def test_fid_and_inception_score_match_jax():
    rng = np.random.RandomState(3)
    real = rng.randn(40, 16)
    fake = rng.randn(40, 16) * 1.3 + 0.2
    assert fid_is.compute_fid(real, fake) == pytest.approx(
        jax_fid.compute_fid(real, fake), rel=1e-6)
    assert fid_is.compute_fid(real, real) == pytest.approx(0.0, abs=1e-6)
    logits = rng.randn(40, 10) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got, want = (fid_is.compute_inception_score(probs),
                 jax_fid.compute_inception_score(probs))
    assert got == pytest.approx(want, rel=1e-6)
