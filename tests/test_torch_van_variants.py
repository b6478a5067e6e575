"""VAN-B0 to B6 and the four SAM matting variants on VAN-B0 and B1 against
the JAX package's parameter trees, through the weight bridge both ways
(``tests/test_torch_backbone_variants.py::assert_backbone_tree``,
``assert_sam_matting_tree``), each traced by ``jax.eval_shape`` and built
on the meta device."""

import pytest

from _torch_port import one_torch_thread
from test_torch_backbone_variants import (BACKBONE_NAMES, MATTING_NAMES,
                                         assert_backbone_tree,
                                         assert_sam_matting_tree)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.mark.parametrize("name", [n for n in BACKBONE_NAMES
                                  if n.startswith("van_")])
def test_van_trees_match_jax(name):
    assert_backbone_tree(name)


@pytest.mark.parametrize("name", [n for n in MATTING_NAMES
                                  if n.startswith(("vanb0", "vanb1"))])
def test_van_sam_matting_variant_trees_match_jax(name):
    assert_sam_matting_tree(name)
