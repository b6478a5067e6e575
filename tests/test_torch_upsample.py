"""The port's matmul resizes against the JAX package's ``ops/upsample.py``
on the CPU: ``resize_bilinear`` with ``align_corners`` True and False at up-
and downscale sizes, forward and VJP in f32 (and in bf16, where both cast
the interpolation matrix to the input's dtype), the align-corners form
against ``F.interpolate``, and ``upsample_nearest_2x`` with its VJP."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from simpleaicv_tpu.ops import upsample as jax_upsample
from simpleaicv_tpu_torch.models.detection.fpn import _upsample_to
from simpleaicv_tpu_torch.ops.upsample import (resize_bilinear,
                                               upsample_nearest_2x)

from _torch_port import one_torch_thread

SIZES = [((8, 12), (32, 48)), ((16, 16), (64, 64)), ((7, 5), (16, 23)),
         ((32, 48), (8, 12)), ((40, 30), (17, 11)), ((1, 6), (4, 3))]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _inputs(in_hw, out_hw, seed=0, c=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *in_hw, c).astype(np.float32)
    dy = rng.randn(2, *out_hw, c).astype(np.float32)
    return x, dy


def _jax_vjp(x, out_hw, dy, align_corners):
    y, vjp = jax.vjp(lambda t: jax_upsample.resize_bilinear(
        t, out_hw, align_corners=align_corners), jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_resize_and_vjp_match_jax(in_hw, out_hw, align_corners):
    x, dy = _inputs(in_hw, out_hw)
    want, want_dx = _jax_vjp(x, out_hw, dy, align_corners)
    t = torch.from_numpy(x).requires_grad_()
    y = resize_bilinear(t, out_hw, align_corners=align_corners)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), want_dx, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", SIZES[:3] + SIZES[4:5])
def test_align_corners_is_f_interpolate(in_hw, out_hw):
    """The corners-to-corners matrix is ``F.interpolate(align_corners=True)``
    (which does not antialias when shrinking either), within f32 rounding
    of its source coordinates."""
    x, _ = _inputs(in_hw, out_hw)
    t = torch.from_numpy(x)
    want = F.interpolate(t.permute(0, 3, 1, 2), size=out_hw,
                         mode="bilinear", align_corners=True)
    got = _upsample_to(t, *out_hw)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5)
    assert _upsample_to(t, *in_hw) is t


@pytest.mark.parametrize("align_corners", [True, False])
def test_bf16_casts_the_matrix_as_jax_does(align_corners):
    """bf16 in, bf16 out, the weights rounded to bf16 and the products
    summed in f32: the JAX result's bits."""
    x, _ = _inputs((16, 12), (40, 30), seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_upsample.resize_bilinear(
        xb, (40, 30), align_corners=align_corners).astype(jnp.float32))
    got = resize_bilinear(torch.from_numpy(x).to(torch.bfloat16), (40, 30),
                          align_corners=align_corners)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_upsample_nearest_2x_and_vjp_match_jax():
    x, dy = _inputs((5, 7), (10, 14))
    y, vjp = jax.vjp(jax_upsample.upsample_nearest_2x, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = upsample_nearest_2x(t)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[0]),
                               atol=1e-6)
