"""The PFAN variants on VAN-B0 to B3 and the four ConvFormers (salient
detection, matting, face and human parsing) against the JAX package's
parameter trees, through the weight bridge both ways
(``tests/test_torch_backbone_variants.py::_assert_bridge``): 32 models,
each traced by ``jax.eval_shape`` (face and human parsing share one trace)
and built on the meta device."""

import jax
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu_torch.core.registry import MODELS

from _torch_port import one_torch_thread
from test_torch_backbone_variants import (PFAN_NAMES, _assert_bridge, _image,
                                         jax_tree)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("name", PFAN_NAMES)
def test_pfan_variant_trees_match_jax(name):
    # face and human parsing build the same JAX model (``PFANParsing``)
    key = name.replace("human_parsing", "face_parsing")
    jm = JAX_MODELS.create(key)
    variables = jax_tree(key, lambda: jm.init(jax.random.PRNGKey(0),
                                              _image(), False))
    with torch.device("meta"):
        model = MODELS.create(name)
    _assert_bridge(model, variables)


