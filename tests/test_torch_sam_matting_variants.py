"""The twelve SAM matting variants on ConvFormer and VAN-B3 against the JAX
package's parameter trees, initialised as ``tools/train_interactive_
matting.py`` initialises them (no mask prompt), through the weight bridge
both ways (``tests/test_torch_backbone_variants.py::
assert_sam_matting_tree``), each traced by ``jax.eval_shape`` (the
ConvFormer-M36 aliases share their names' traces) and built on the meta
device. The others: ``tests/test_torch_{van,light_sam}_variants.py``."""

import pytest

from _torch_port import one_torch_thread
from test_torch_backbone_variants import (MATTING_NAMES,
                                         assert_sam_matting_tree)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("name", [n for n in MATTING_NAMES
                                  if n.startswith(("convformer", "vanb3"))])
def test_sam_matting_variant_trees_match_jax(name):
    assert_sam_matting_tree(name)
