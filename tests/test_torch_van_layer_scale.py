"""VAN-B3 (3, 5, 27, 3 blocks) in eval mode at 256^2 from random weights
drawn as ``chip_smoke.py::_fill_on_card`` draws them (kernels normal at
1 / sqrt(fan in), the running statistics 0 and 1): with its layer scales
at 0.1 the stream overflows in both packages, in f32 and in the port's
bf16 (the card's compute dtype, with f32's range), first at the same
block, and at the init's 1e-5 it stays finite. LKA's gate multiplies each
block's branch by its own input, so the branch grows with the square of
the stream, and eval-mode BatchNorms with these statistics renormalise
nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params)

from _torch_port import jax_f32, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


_JAX_VAN_B3 = JAX_BACKBONES.create("van_b3", features_only=True)
_jax_van_b3 = jax.jit(lambda v, x: _JAX_VAN_B3.apply(
    v, x, False, capture_intermediates=True, mutable=["intermediates"]))


def _first_non_finite(model, image):
    names, finite = [], []
    for i in range(1, 5):
        for j, blk in enumerate(getattr(model, f"block{i}")):
            names.append(f"block{i}_{j}")
            blk.register_forward_hook(lambda m, a, out: finite.append(
                bool(torch.isfinite(out).all())))
    with torch.no_grad():
        model.eval()(torch.from_numpy(image))
    return next((n for n, ok in zip(names, finite) if not ok), None), names


def _first_non_finite_blocks(layer_scale, size=256):
    """(the port's in f32, the port's in bf16, JAX's in f32) first VAN-B3
    block whose output is not finite, or None, in eval mode from the same
    weights and image."""
    model = BACKBONES.create("van_b3", features_only=True,
                             dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            elif "layer_scale" in name:
                p.fill_(layer_scale)
            else:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
    bf16 = BACKBONES.create("van_b3", features_only=True,
                            dtype=torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    image = np.random.RandomState(1).randn(1, size, size, 3).astype(
        np.float32)
    variables = {"params": export_jax_params(model),
                 "batch_stats": export_jax_batch_stats(model)}
    mine, names = _first_non_finite(model, image)
    mine_bf16, _ = _first_non_finite(bf16, image)
    with jax_f32():
        _, state = _jax_van_b3(variables, jnp.asarray(image))
    theirs = next((n for n in names if not np.isfinite(np.asarray(
        state["intermediates"][n]["__call__"][0])).all()), None)
    return mine, mine_bf16, theirs


def test_van_b3_overflows_alike_in_both_packages_at_layer_scales_of_0_1():
    assert _first_non_finite_blocks(0.1) == ("block4_0",) * 3
    assert _first_non_finite_blocks(1e-5) == (None,) * 3
