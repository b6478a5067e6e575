"""The ten LightSAM variants on VAN and ConvFormer backbones against the JAX
package's parameter trees, initialised as ``tools/train_interactive_
segmentation.py`` initialises them (with a mask prompt), through the
weight bridge both ways (``tests/test_torch_backbone_variants.py::
_assert_bridge``), traced by ``jax.eval_shape`` (the two aliases share
their names' traces) and built on the meta device; and the two SAM
matting variants on VAN-B2 (``assert_sam_matting_tree``)."""

import jax
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu_torch.core.registry import MODELS

from _torch_port import one_torch_thread
from test_torch_backbone_variants import (IMG, LIGHT_SAM_NAMES, MATTING_NAMES,
                                         _assert_bridge, _image, _prompts,
                                         assert_sam_matting_tree, jax_tree)

# the JAX package's aliases of two of the reference's names
_SAME = {"convformer_m36_light_sam": "convformerm36_light_sam",
         "van_b3_light_sam": "vanb3_light_sam"}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("name", LIGHT_SAM_NAMES)
def test_light_sam_variant_trees_match_jax(name):
    key = _SAME.get(name, name)
    jm = JAX_MODELS.create(key, image_size=IMG)
    variables = jax_tree(key, lambda: jm.init(
        jax.random.PRNGKey(0), _image(), _prompts(IMG, True), (0, 1, 2, 3),
        True))
    with torch.device("meta"):
        model = MODELS.create(name, image_size=IMG)
    _assert_bridge(model, variables)


@pytest.mark.parametrize("name", [n for n in MATTING_NAMES
                                  if n.startswith("vanb2")])
def test_vanb2_sam_matting_variant_trees_match_jax(name):
    assert_sam_matting_tree(name)
