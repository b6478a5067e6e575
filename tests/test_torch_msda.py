"""The port's multi-scale deformable attention against the JAX package's, in
f32 on the CPU: ``ms_deform_attn`` (on CPU tensors: the plain version and
its autograd) against ``ms_deform_attn_xla`` and the Pallas kernel
``ms_deform_attn_pallas`` in interpret mode, forward and gradients in the
value, the locations and the weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.ops.msda import ms_deform_attn_xla
from simpleaicv_tpu.ops.msda_pallas import ms_deform_attn_pallas
from simpleaicv_tpu_torch.ops import msda

# (name, B, Lq, H, D, levels, P, location range): D 8 and 32, one and five
# levels (a 2x2 tail), locations off the map on both sides
CASES = [
    ("one_level_d8", 2, 20, 2, 8, ((8, 8),), 3, (-0.1, 1.1)),
    ("two_levels_d16", 2, 20, 2, 16, ((8, 8), (4, 4)), 3, (-0.1, 1.1)),
    ("five_levels_d32", 1, 16, 8, 32,
     ((16, 16), (8, 8), (4, 4), (2, 2), (3, 5)), 4, (-0.2, 1.2)),
    ("one_level_d32_inside", 2, 13, 4, 32, ((6, 10),), 4, (0.0, 1.0)),
]


def _inputs(b, lq, h, d, shapes, p, lo, hi, seed):
    rng = np.random.RandomState(seed)
    s = sum(hh * ww for hh, ww in shapes)
    value = rng.randn(b, s, h, d).astype(np.float32)
    locs = rng.uniform(lo, hi, (b, lq, h, len(shapes), p, 2)).astype(
        np.float32)
    weights = rng.rand(b, lq, h, len(shapes), p).astype(np.float32)
    return value, locs, weights


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_xla_and_pallas(case):
    _, b, lq, h, d, shapes, p, (lo, hi) = case
    value, locs, weights = _inputs(b, lq, h, d, shapes, p, lo, hi, 0)
    args = (jnp.asarray(value), shapes, jnp.asarray(locs),
            jnp.asarray(weights))
    xla = np.asarray(ms_deform_attn_xla(*args))
    pallas = np.asarray(ms_deform_attn_pallas(*args, block_q=16))
    got = msda.ms_deform_attn(torch.from_numpy(value), shapes,
                              torch.from_numpy(locs),
                              torch.from_numpy(weights))
    assert got.shape == (b, lq, h * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=0)


def _rel_max(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_gradients_match_jax_grad(case):
    """Value, location and weight gradients within 1e-4 of each gradient's
    largest value (the location gradients carry factors of w_l and h_l)."""
    _, b, lq, h, d, shapes, p, (lo, hi) = case
    value, locs, weights = _inputs(b, lq, h, d, shapes, p, lo, hi, 1)
    g_out = np.random.RandomState(2).randn(b, lq, h * d).astype(np.float32)

    def f(v, l, w):
        return jnp.sum(ms_deform_attn_xla(v, shapes, l, w) * g_out)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(value), jnp.asarray(locs), jnp.asarray(weights))
    inputs = [torch.from_numpy(a).requires_grad_()
              for a in (value, locs, weights)]
    out = msda.ms_deform_attn(inputs[0], shapes, *inputs[1:])
    out.backward(torch.from_numpy(g_out))
    for name, t, w in zip(("value", "locations", "weights"), inputs, want):
        assert _rel_max(t.grad.numpy(), np.asarray(w)) <= 1e-4, name
    # the plain backward on its own gives the same gradients
    plain = msda.ms_deform_attn_backward_reference(
        torch.from_numpy(value), shapes, torch.from_numpy(locs),
        torch.from_numpy(weights), torch.from_numpy(g_out))
    for t, got in zip(inputs, plain):
        np.testing.assert_array_equal(got.numpy(), t.grad.numpy())


def test_integer_locations_and_cell_centres():
    """Samples exactly on pixel centres read the value itself; on integer
    pixel coordinates (a cell border) they blend two cells equally."""
    shapes = ((4, 6),)
    rng = np.random.RandomState(3)
    value = rng.randn(1, 24, 1, 8).astype(np.float32)
    centres = np.array([[(x + 0.5) / 6, (y + 0.5) / 4]
                        for y in range(4) for x in range(6)], np.float32)
    locs = centres[None, :, None, None, None, :]
    weights = np.ones((1, 24, 1, 1, 1), np.float32)
    got = msda.ms_deform_attn(torch.from_numpy(value), shapes,
                              torch.from_numpy(locs),
                              torch.from_numpy(weights)).numpy()
    np.testing.assert_allclose(got[0], value[0, :, 0], atol=1e-6)
    border = np.array([[[[[[2.0 / 6, 1.5 / 4]]]]]], np.float32)  # x = 1.5
    got = msda.ms_deform_attn(torch.from_numpy(value), shapes,
                              torch.from_numpy(border),
                              torch.ones(1, 1, 1, 1, 1)).numpy()
    want = 0.5 * (value[0, 7, 0] + value[0, 8, 0])
    np.testing.assert_allclose(got[0, 0], want, atol=1e-6)
    xla = ms_deform_attn_xla(jnp.asarray(value), shapes, jnp.asarray(border),
                             jnp.ones((1, 1, 1, 1, 1)))
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-6)


def test_checks_shapes():
    value = torch.zeros(1, 20, 2, 4)
    locs = torch.zeros(1, 3, 2, 1, 2, 2)
    weights = torch.zeros(1, 3, 2, 1, 2)
    with pytest.raises(ValueError, match="do not cover"):
        msda.ms_deform_attn(value, ((4, 4),), locs, weights)
    with pytest.raises(ValueError, match="attention_weights"):
        msda.ms_deform_attn(value, ((4, 5),), locs, weights[..., :1])
    with pytest.raises(ValueError, match="sampling_locations"):
        msda.ms_deform_attn(value, ((4, 5),), locs[..., :1], weights)
    assert msda.KERNEL_LAUNCHES == {"msda_fwd": 0, "msda_bwd": 0}


def _shifted(shape, offset, dtype=torch.float32):
    """A contiguous tensor of ``shape`` that starts ``offset`` elements into
    its buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("d,levels,points,dtype,offset,want", [
    (32, ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16)), 4,
     torch.float32, 0, "tiled"),                   # DINO-DETR's launches
    (32, ((8, 8),), 4, torch.float32, 0, "tiled"),   # one small level
    (64, ((64, 64), (48, 48)), 4, torch.float32, 0, "tiled"),  # none fits
    (8, ((8, 8), (4, 4)), 3, torch.float32, 0, "tiled"),
    (4, ((6, 5),), 2, torch.float32, 0, "tiled"),
    (48, ((12, 10), (5, 7)), 4, torch.float32, 0, "tiled"),
    (32, ((8, 8),), 4, torch.float32, 4, "tiled"),  # 16 bytes in: aligned
    (32, ((8, 8),), 4, torch.float32, 1, "narrow"),  # 4 bytes off alignment
    (32, ((8, 8),), 4, torch.bfloat16, 1, "tiled"),  # the f32 copy aligns
    (6, ((8, 8),), 4, torch.float32, 0, "narrow"),   # D no multiple of 4
    (30, ((8, 8),), 4, torch.float32, 0, "narrow"),
    (32, ((4, 4),) * 8, 5, torch.float32, 0, "narrow"),  # 40 samples
    (32, ((4, 4),) * 8, 4, torch.float32, 0, "tiled"),   # 32 samples
])
def test_msda_backward_variant(d, levels, points, dtype, offset, want):
    """The MSDA backward (K7b) picks its kernel from the head width, the
    number of samples a (query, head) and the alignment of value and the
    locations as launched alone, as ``csrc/msda.cu`` documents, never from
    where the samples lie, and launches nothing to do so."""
    s = sum(h * w for h, w in levels)
    value = _shifted((2, s, 2, d), offset, dtype)
    loc = torch.rand(2, 3, 2, len(levels), points, 2)
    before = dict(msda.KERNEL_LAUNCHES)
    assert msda._msda_bwd_variant(value, levels, loc) == want
    assert msda._msda_bwd_variant(value, levels, loc * 3 - 1) == want
    assert msda.KERNEL_LAUNCHES == before
    # the locations' own alignment: 8 bytes
    moved = _shifted(tuple(loc.shape), 1)
    assert msda._msda_bwd_variant(value.float().contiguous(), levels,
                                  moved) == "narrow"
