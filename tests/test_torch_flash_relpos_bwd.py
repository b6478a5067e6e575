"""Gradients of the port's rel-pos flash attention
(``simpleaicv_tpu_torch.ops.flash_attention.flash_attention_relpos``) against
``jax.grad`` of the JAX package's: the Pallas kernels in interpret mode
(``_relpos_dq_kernel``, ``_relpos_dkv_kernel`` behind the custom VJP) and the
XLA twin ``flash_attention_relpos_xla``.

On the CPU the port's autograd Function runs its plain versions, so these
tests hold its wiring and arithmetic; the hand kernels are checked against
the plain versions on the card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.ops import flash_attention as jax_fa
from simpleaicv_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, flash_attention_relpos,
    flash_attention_relpos_dkv_reference, flash_attention_relpos_dq_reference,
    flash_attention_relpos_reference)

NAMES = ("dq", "dk", "dv", "drh", "drw")
ATOL = 1e-4   # f32 sums over up to 256 keys in another order

# (BH, k_h, k_w, d): a square grid, a non-square grid with a head dim that is
# no multiple of 16, and N = 60, which no 64-query tile divides
SHAPES = [(3, 16, 16, 32), (2, 8, 16, 40), (2, 6, 10, 16)]


def _inputs(bh, k_h, k_w, d, seed):
    """q, k, v, rel_h, rel_w and the cotangent dO, f32 numpy."""
    rng = np.random.RandomState(seed)
    n = k_h * k_w
    return [rng.randn(*shape).astype(np.float32) for shape in
            ((bh, n, d), (bh, n, d), (bh, n, d), (bh, n, k_h), (bh, n, k_w),
             (bh, n, d))]


def _port_grads(arrs, dtype=torch.float32):
    *args, do = (torch.from_numpy(a) for a in arrs)
    args = [a.to(dtype) if i < 3 else a for i, a in enumerate(args)]
    args = [a.requires_grad_() for a in args]
    o, lse = flash_attention_relpos(*args)
    assert not lse.requires_grad
    grads = torch.autograd.grad(o, args, do.to(dtype))
    assert [g.dtype for g in grads] == [dtype] * 3 + [torch.float32] * 2
    return [g.float().numpy() for g in grads]


def _jax_grads(fn, arrs, dtype=jnp.float32):
    *args, do = map(jnp.asarray, arrs)
    args = [a.astype(dtype) if i < 3 else a for i, a in enumerate(args)]
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(do.astype(dtype))]


@pytest.mark.parametrize("twin", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("bh,k_h,k_w,d", SHAPES)
def test_relpos_gradients_match_jax(bh, k_h, k_w, d, twin):
    arrs = _inputs(bh, k_h, k_w, d, seed=bh * 100 + k_w)
    if twin == "xla":
        fn = jax_fa.flash_attention_relpos_xla
    else:
        fn = lambda *a: jax_fa.flash_attention_relpos(  # noqa: E731
            *a, interpret=True)
    before = dict(KERNEL_LAUNCHES)
    got = _port_grads(arrs)
    assert KERNEL_LAUNCHES == before  # CPU tensors launch nothing
    for name, g, w in zip(NAMES, got, _jax_grads(fn, arrs)):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)


def test_relpos_gradients_match_xla_twin_in_bf16():
    """bf16 q, k, v and dO, f32 rel_h and rel_w. The port rounds p and ds
    where the twin rounds them, but the two forwards may round o to
    neighbouring bf16 values, which moves delta = rowsum(dO * o): every
    gradient is held to two bf16 steps at its largest value (a step there is
    at most 2^-7 of it)."""
    arrs = _inputs(2, 8, 16, 32, seed=11)
    got = _port_grads(arrs, torch.bfloat16)
    want = _jax_grads(jax_fa.flash_attention_relpos_xla, arrs, jnp.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, atol=2 * 2.0**-7 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("bh,k_h,k_w,d", SHAPES)
def test_plain_backward_equals_autograd_of_plain_forward(bh, k_h, k_w, d):
    """``flash_attention_relpos_dq_reference`` and ``..._dkv_reference`` from
    (o, lse, delta) against autograd through the plain forward, f32."""
    q, k, v, rh, rw, do = (torch.from_numpy(a)
                           for a in _inputs(bh, k_h, k_w, d, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rh, rw)]
    o, lse = flash_attention_relpos_reference(*leaves)
    want = torch.autograd.grad(o, leaves, do)
    delta = (do * o.detach()).sum(dim=-1)
    args = (q, k, v, rh, rw, do, lse.detach(), delta)
    dq, drh, drw = flash_attention_relpos_dq_reference(*args)
    dk, dv = flash_attention_relpos_dkv_reference(*args)
    for name, g, w in zip(NAMES, (dq, dk, dv, drh, drw), want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)


def test_relpos_backward_takes_a_strided_cotangent():
    """dO as SAM's head merge hands it back: a view that is not
    contiguous."""
    arrs = _inputs(2, 4, 8, 16, seed=3)
    want = _port_grads(arrs)
    *args, do = (torch.from_numpy(a) for a in arrs)
    args = [a.requires_grad_() for a in args]
    o, _ = flash_attention_relpos(*args)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    got = torch.autograd.grad(o, args, strided)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
