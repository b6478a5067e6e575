"""The port's rel-pos flash attention (simpleaicv_tpu_torch.ops) against the
JAX package's: the Pallas kernel in interpret mode and its XLA twin.

On the CPU the port's wrapper runs its plain version; the hand kernel is
checked against that plain version on the card
(``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.ops import flash_attention as jax_fa
from simpleaicv_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, flash_attention_relpos, flash_attention_relpos_reference)

ATOL = 2e-5


def _inputs(bh, k_h, k_w, d, seed):
    rng = np.random.RandomState(seed)
    n = k_h * k_w
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((bh, n, d), (bh, n, d), (bh, n, d), (bh, n, k_h), (bh, n, k_w))]


# (BH, k_h, k_w, d): SAM-like square grid, a non-square grid with an odd
# head dim, and N = 60, which no 64-query tile divides (the padded tail)
SHAPES = [(3, 16, 16, 32), (2, 8, 16, 40), (2, 6, 10, 16)]


@pytest.mark.parametrize("bh,k_h,k_w,d", SHAPES)
def test_flash_relpos_matches_jax(bh, k_h, k_w, d):
    arrs = _inputs(bh, k_h, k_w, d, seed=bh * 100 + k_w)
    o, lse = flash_attention_relpos(*map(torch.from_numpy, arrs))
    assert o.dtype == torch.float32 and lse.shape == (bh, k_h * k_w)

    q, k, v, rh, rw = map(jnp.asarray, arrs)
    n = k_h * k_w
    # the Pallas kernel, in interpret mode as the JAX package's tests run it
    o_pl, lse_pl = jax_fa._relpos_fwd_call(q, k, v, rh, rw, min(128, n),
                                           True)
    np.testing.assert_allclose(
        np.asarray(jax_fa.flash_attention_relpos(q, k, v, rh, rw,
                                                 interpret=True)),
        np.asarray(o_pl), atol=1e-6)
    # the XLA twin that ran on the TPU
    o_xla = jax_fa.flash_attention_relpos_xla(q, k, v, rh, rw)
    _, lse_xla = jax_fa._xla_fwd_pass(q, k, v, (rh, rw),
                                      jax_fa._relpos_block_k(k_h, k_w))
    for o_j, lse_j in ((o_pl, lse_pl), (o_xla, lse_xla)):
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL)


def test_flash_relpos_cpu_bf16_keeps_dtype_and_counts_no_launch():
    arrs = _inputs(2, 8, 16, 32, seed=7)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs[:3])
    rh, rw = map(torch.from_numpy, arrs[3:])
    before = dict(KERNEL_LAUNCHES)
    o, lse = flash_attention_relpos(q, k, v, rh, rw)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert KERNEL_LAUNCHES == before
    o_ref, lse_ref = flash_attention_relpos_reference(q.float(), k.float(),
                                                      v.float(), rh, rw)
    torch.testing.assert_close(lse, lse_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(o.float(), o_ref, atol=8e-3, rtol=0)


def test_flash_relpos_rejects_bad_shapes():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 4, 4, 8, seed=0)]
    with pytest.raises(ValueError):
        flash_attention_relpos(*arrs[:3], arrs[3][..., :3], arrs[4])
    with pytest.raises(ValueError):
        flash_attention_relpos(arrs[0], arrs[1][:, :8], *arrs[2:])
