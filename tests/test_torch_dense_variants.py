"""FCOS, DBNet, SOLOv2, YOLACT and DeepLabV3+ on VAN-B2 and ConvFormer-M36
against the JAX package's parameter trees, through the weight bridge both
ways (``tests/test_torch_backbone_variants.py::_assert_bridge``), each
traced by ``jax.eval_shape`` and built on the meta device; and the forward
of two family variants on tiny VAN and ConvFormer backbones: DeepLabV3+ on
a tiny ConvFormer and DBNet on a tiny VAN (``tiny_convformer``,
``tiny_van``, registered in both packages' registries), from seeded
weights, in eval and train mode: the outputs within 1e-4 of their largest
value and the new BatchNorm statistics within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.models.backbones import convformer as jax_convformer
from simpleaicv_tpu.models.backbones import van as jax_van
from simpleaicv_tpu_torch.core import weights
from simpleaicv_tpu_torch.core.registry import BACKBONES, MODELS
from simpleaicv_tpu_torch.models.backbones import convformer, van

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)
from test_torch_backbone_variants import (DENSE_NAMES, IMG, _assert_bridge,
                                         _image)

TINY_CONVFORMER = dict(embedding_planes=(8, 16, 24, 32),
                       block_nums=(1, 1, 1, 1))
TINY_VAN = dict(TINY_CONVFORMER, mlp_ratios=(2, 2, 2, 2))



@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _register_tiny():
    if "tiny_convformer" not in BACKBONES:
        BACKBONES.register("tiny_convformer")(
            lambda **kw: convformer.MetaFormer(**TINY_CONVFORMER, **kw))
        BACKBONES.register("tiny_van")(
            lambda **kw: van.VAN(**TINY_VAN, **kw))
    if "tiny_convformer" not in JAX_BACKBONES:
        JAX_BACKBONES.register("tiny_convformer")(
            lambda **kw: jax_convformer.MetaFormer(**TINY_CONVFORMER, **kw))
        JAX_BACKBONES.register("tiny_van")(
            lambda **kw: jax_van.VAN(**TINY_VAN, **kw))


@pytest.mark.parametrize("name", DENSE_NAMES)
def test_dense_variant_trees_match_jax(name):
    jm = JAX_MODELS.create(name)
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               _image(), False))
    with torch.device("meta"):
        model = MODELS.create(name)
    _assert_bridge(model, variables)


@pytest.mark.parametrize("name,kwargs", [
    ("deeplabv3plus", dict(backbone_type="tiny_convformer", planes=16,
                           num_classes=5)),
    ("dbnet", dict(backbone_type="tiny_van", inter_planes=32)),
])
def test_family_forward_on_tiny_backbones_matches_jax(name, kwargs):
    """Eval-mode outputs, then train-mode outputs and new statistics."""
    _register_tiny()
    if name == "deeplabv3plus":
        from simpleaicv_tpu.models.segmentation.deeplabv3plus import \
            DeepLabV3Plus as JaxModel
        from simpleaicv_tpu_torch.models.segmentation.deeplabv3plus import \
            DeepLabV3Plus as PortModel
    else:
        from simpleaicv_tpu.models.text_detection import DBNet as JaxModel
        from simpleaicv_tpu_torch.models.text_detection import \
            DBNet as PortModel
    rng = np.random.RandomState(0)
    image = (rng.rand(2, IMG, IMG, 3) + rng.randn(2, 1, 1, 3)).astype(
        np.float32)
    jm = JaxModel(**kwargs)
    with jax_f32():
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                jnp.asarray(image), False))
        variables = {"params": random_params(shapes["params"], seed=1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], seed=2)}
        train_out, new = jax.jit(lambda v, x: jm.apply(
            v, x, True, mutable=["batch_stats"]))(variables,
                                                  jnp.asarray(image))
        eval_out = jax.jit(lambda v, x: jm.apply(v, x, False))(
            variables, jnp.asarray(image))
    model = weights.load_jax_params(
        PortModel(dtype=torch.float32, **kwargs), variables["params"],
        batch_stats=variables["batch_stats"])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(image), False)
        want = np.asarray(eval_out)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        got = model.train()(torch.from_numpy(image), True)
        want = np.asarray(train_out)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
        stats = flatten_tree(weights.export_jax_batch_stats(model))
        for path, w in flatten_tree(jax.tree.map(
                np.asarray, new["batch_stats"])).items():
            np.testing.assert_allclose(stats[path], w, atol=1e-5,
                                       err_msg=path)
