"""The plain versions of the roofline probes P1-P3 (``simpleaicv_tpu_torch/
perf/matmul_probe.py``, ``bw_probe.py``) against the JAX Pallas functions
themselves, run in interpret mode on the CPU, and the wrappers' checks.

Tolerances: against the f32 product of the same bf16 inputs, each bf16
output lies within 4e-3 (half a bf16 spacing at |y| < 2: 2^-9 = 2e-3 below
1, 3.9e-3 in [1, 2)); the column sums lie within 2e-5 of their largest
value (f32 sums of 1024 terms in another order). P3's product by
bf16(1.0001) = 1.0 is exact.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from simpleaicv_tpu_torch.perf import bw_probe, matmul_probe

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from perf.pallas_bw_probe import pallas_scale  # noqa: E402
from perf.pallas_matmul_probe import pallas_mm  # noqa: E402

M, K, N = 1024, 64, 256


@pytest.fixture(scope="module")
def inputs():
    """bf16 x [M, K] and w [K, N] as numpy f32 (exact bf16 values), and
    the Pallas outputs: P1's y, P2's (y, s1, s2), P3's o."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(M, K), jnp.bfloat16)
    w = jnp.asarray(rng.randn(K, N) * 0.03, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        y = jax.jit(lambda a, b: pallas_mm(a, b, tile_m=256))(x, w)
        stats = jax.jit(lambda a, b: pallas_mm(a, b, tile_m=256,
                                               stats=True))(x, w)
        o = jax.jit(lambda a: pallas_scale(a, 256))(x)
    as_np = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (as_np(x), as_np(w), as_np(y), [as_np(s) for s in stats],
            as_np(o))


def _bf16(a):
    return torch.from_numpy(a.copy()).to(torch.bfloat16)


def _f32_product(x, w):
    return x.astype(np.float64) @ w.astype(np.float64)


@pytest.mark.parametrize("which", ["pallas", "port"])
def test_mm_within_half_a_bf16_spacing_of_f32_product(inputs, which):
    x, w, y_pallas, _, _ = inputs
    y = (y_pallas if which == "pallas"
         else matmul_probe.probe_mm(_bf16(x), _bf16(w)).float().numpy())
    want = _f32_product(x, w)
    assert np.abs(want).max() < 2.0
    assert y.shape == (M, N)
    assert np.abs(y - want).max() <= 4e-3


def test_mm_plain_matches_pallas(inputs):
    """The two round the same f32 product: they differ by at most one bf16
    spacing, where the sums' order tips a rounding."""
    x, w, y_pallas, _, _ = inputs
    y = matmul_probe.mm_plain(_bf16(x), _bf16(w)).float().numpy()
    spacing = 2.0 ** (np.floor(np.log2(np.abs(y_pallas) + 1e-30)) - 7)
    assert np.all(np.abs(y - y_pallas) <= spacing)


@pytest.mark.parametrize("which", ["pallas", "port"])
def test_mm_stats_sums_of_f32_product(inputs, which):
    x, w, _, (y_p, s1_p, s2_p), _ = inputs
    if which == "pallas":
        y, s1, s2 = y_p, s1_p, s2_p
    else:
        y, s1, s2 = (t.float().numpy() for t in matmul_probe.probe_mm(
            _bf16(x), _bf16(w), stats=True))
    want = _f32_product(x, w)
    assert s1.shape == (1, N) and s2.shape == (1, N)
    assert np.abs(y - want).max() <= 4e-3
    for got, ref in [(s1[0], want.sum(0)), (s2[0], (want**2).sum(0))]:
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def test_mm_stats_plain_matches_pallas(inputs):
    x, w, _, (_, s1_p, s2_p), _ = inputs
    _, s1, s2 = matmul_probe.mm_stats_plain(_bf16(x), _bf16(w))
    for got, ref in [(s1.numpy(), s1_p), (s2.numpy(), s2_p)]:
        assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def test_scale_exact(inputs):
    x, _, _, _, o_pallas = inputs
    o = bw_probe.probe_scale(_bf16(x))
    assert o.dtype == torch.bfloat16
    np.testing.assert_array_equal(o.float().numpy(), o_pallas)
    np.testing.assert_array_equal(o_pallas, x)  # bf16(1.0001) == 1.0


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU no kernel is built or launched, and nothing is counted."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(matmul_probe, "_lib", no_build)
    monkeypatch.setattr(bw_probe, "_lib", no_build)
    before = (dict(matmul_probe.KERNEL_LAUNCHES),
              dict(bw_probe.KERNEL_LAUNCHES))
    x = torch.randn(300, 32).bfloat16()     # a ragged M is fine here
    w = torch.randn(32, 64).bfloat16()
    torch.testing.assert_close(matmul_probe.probe_mm(x, w),
                               matmul_probe.mm_plain(x, w))
    got = matmul_probe.probe_mm(x, w, stats=True)
    for a, b in zip(got, matmul_probe.mm_stats_plain(x, w)):
        torch.testing.assert_close(a, b)
    torch.testing.assert_close(bw_probe.probe_scale(x),
                               bw_probe.scale_plain(x))
    assert (dict(matmul_probe.KERNEL_LAUNCHES),
            dict(bw_probe.KERNEL_LAUNCHES)) == before


@pytest.mark.parametrize("x_shape,w_shape,dtype,match", [
    ((8, 16), (32, 64), torch.bfloat16, r"x must be \[M, K\]"),
    ((8, 16, 1), (16, 64), torch.bfloat16, r"x must be \[M, K\]"),
    ((8, 16), (16, 64), torch.float32, "the probe is bf16"),
])
def test_mm_checks_shapes_and_dtypes(x_shape, w_shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        matmul_probe.probe_mm(torch.zeros(x_shape, dtype=dtype),
                              torch.zeros(w_shape, dtype=dtype))


def test_scale_checks_dtype_and_device():
    with pytest.raises(ValueError, match="the probe is bf16"):
        bw_probe.probe_scale(torch.zeros(8))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bw_probe.probe_scale(torch.zeros(8, dtype=torch.bfloat16,
                                         device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        matmul_probe.probe_mm(
            torch.zeros(8, 16, dtype=torch.bfloat16, device="meta"),
            torch.zeros(16, 64, dtype=torch.bfloat16, device="meta"))


VARIANT_CASES = [
    (64, 256, 0, "stream"),    # ResNet-50's layer 1
    (128, 512, 0, "stream"),   # layer 2
    (64, 64, 0, "stream"),
    (128, 192, 0, "stream"),
    (64, 576, 0, "narrow"),    # N above 512
    (48, 256, 0, "narrow"),    # K no multiple of 64
    (16, 64, 0, "narrow"),
    (112, 128, 0, "narrow"),
    (64, 256, 2, "narrow"),    # x 4 bytes off 16-byte alignment
    (64, 256, 8, "stream"),    # 16 bytes in: aligned
]


# P1's cases keep their names; P2's carry "-stats"
@pytest.mark.parametrize("k,n,offset,want,stats", [
    pytest.param(*case, stats,
                 id="-".join(map(str, case)) + ("-stats" if stats else ""))
    for stats in (False, True) for case in VARIANT_CASES])
def test_mm_variant(k, n, offset, want, stats, monkeypatch):
    """P1 and P2 pick their kernel by one rule, from K, N and the
    alignment of x and w alone, as ``csrc/probes.cu`` documents, and
    launch nothing to do so."""
    def no_build():
        raise AssertionError("choosing a variant reached the kernel")

    monkeypatch.setattr(matmul_probe, "_lib", no_build)
    x = torch.zeros(300 * k + offset, dtype=torch.bfloat16)[offset:].view(
        300, k)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    name = "probe_mm_stats" if stats else "probe_mm"
    before = (dict(matmul_probe.KERNEL_LAUNCHES),
              dict(matmul_probe.NARROW_LAUNCHES))
    assert name in before[0] and name in before[1]
    assert matmul_probe._mm_variant(x, w) == want
    assert (matmul_probe.KERNEL_LAUNCHES,
            matmul_probe.NARROW_LAUNCHES) == before
