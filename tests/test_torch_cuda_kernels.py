"""The port's hand CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no card.

This file imports torch and the port only, neither JAX nor the JAX package,
so that it also runs on a machine that has a card and no flax:

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from simpleaicv_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, flash_attention, flash_attention_backward_reference,
    flash_attention_reference, flash_attention_relpos,
    flash_attention_relpos_dkv_reference, flash_attention_relpos_dq_reference,
    flash_attention_relpos_reference)

pytestmark = pytest.mark.cuda

TOLERANCES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("dtype,atol", TOLERANCES)
def test_kernel_matches_plain_version_on_card(dtype, atol):
    """The rel-pos forward kernel: SAM-B and SAM-H global layers, a
    non-square grid, and N = 60, which no 64-query tile divides."""
    for bh, k_h, k_w, d in [(3, 16, 16, 32), (2, 8, 16, 40), (2, 6, 10, 16),
                            (12, 64, 64, 64), (2, 64, 64, 80)]:
        rng = np.random.RandomState(1)
        n = k_h * k_w
        q, k, v = (_randn(rng, bh, n, d).to("cuda", dtype) for _ in range(3))
        rh, rw = _randn(rng, bh, n, k_h).cuda(), _randn(rng, bh, n, k_w).cuda()
        launches = KERNEL_LAUNCHES["flash_attention_relpos_fwd"]
        o, lse = flash_attention_relpos(q, k, v, rh, rw)
        assert KERNEL_LAUNCHES["flash_attention_relpos_fwd"] == launches + 1
        o_ref, lse_ref = flash_attention_relpos_reference(q, k, v, rh, rw)
        torch.testing.assert_close(o.float(), o_ref.float(), atol=atol,
                                   rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=atol, rtol=0)


def _grad_atol(want, dtype):
    """1e-4 for f32; for bf16 two bf16 steps at the tensor's largest value
    (a step there is at most 2^-7 of it)."""
    if dtype == torch.float32:
        return 1e-4
    return 2 * 2.0**-7 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_versions_on_card(dtype):
    """Forward, dq and dk/dv through autograd, on q, k, v sliced from one
    fused projection: ViT-B and ViT-H token counts, a multiple of the tiles,
    a tail of 5 tokens, and the widest head. In bf16 o may differ by the
    rounding of one result to a neighbour (8e-3: one step in [1, 2), two
    below 1); a gradient also carries the rounding of p or ds before its
    product."""
    for b, h, n, d in [(2, 12, 197, 64), (1, 16, 257, 80), (1, 2, 256, 64),
                       (2, 2, 5, 40), (1, 2, 130, 128)]:
        rng = np.random.RandomState(n)
        qkv = _randn(rng, b, n, 3, h, d).to("cuda", dtype)
        q, k, v = (t.transpose(1, 2).requires_grad_() for t in qkv.unbind(2))
        do = _randn(rng, b, h, n, d).to("cuda", dtype)
        before = dict(KERNEL_LAUNCHES)
        o = flash_attention(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), do)
        for name in ("flash_attention_fwd", "flash_attention_dq",
                     "flash_attention_dkv"):
            assert KERNEL_LAUNCHES[name] == before[name] + 1
        o_ref, lse_ref = flash_attention_reference(q, k, v)
        want = flash_attention_backward_reference(q, k, v, o_ref, lse_ref, do)
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=0,
                                   atol=1e-4 if dtype == torch.float32
                                   else 8e-3)
        for g, w in zip(grads, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=_grad_atol(w, dtype))


def test_flash_kernels_copy_what_they_cannot_read_in_place():
    """A last stride other than 1 goes through a contiguous copy."""
    rng = np.random.RandomState(0)
    q, k, v = (_randn(rng, 1, 2, 8, 70).cuda().transpose(2, 3)
               for _ in range(3))  # [1, 2, 70, 8] with unit stride over N
    o = flash_attention(q, k, v)
    o_ref, _ = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, o_ref, atol=1e-4, rtol=0)


RELPOS_SHAPES = [(3, 16, 16, 32), (2, 8, 16, 40), (3, 10, 10, 40),
                 (12, 64, 64, 64), (2, 64, 64, 80), (2, 16, 24, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relpos_gradients_match_plain_versions_on_card(dtype):
    """The rel-pos backward kernels through autograd: dq, dk, dv, drh, drw
    against the plain versions on the same (o, lse, delta), at SAM-B and
    SAM-H global layers, non-square grids, N = 100 (no 64-query tile divides
    it; k_w = 10 and d = 40 are padded in the kernel) and the widest head.
    f32 tensors, the bias gradients among them: 1e-4; bf16 dq, dk, dv: two
    bf16 steps at the tensor's largest value (``_grad_atol``)."""
    for bh, k_h, k_w, d in RELPOS_SHAPES:
        rng = np.random.RandomState(k_w + d)
        n = k_h * k_w
        q, k, v, do = (_randn(rng, bh, n, d).to("cuda", dtype)
                       for _ in range(4))
        rh, rw = _randn(rng, bh, n, k_h).cuda(), _randn(rng, bh, n, k_w).cuda()
        leaves = [t.requires_grad_() for t in (q, k, v, rh, rw)]
        before = dict(KERNEL_LAUNCHES)
        o, lse = flash_attention_relpos(*leaves)
        assert o.requires_grad and not lse.requires_grad
        dq, dk, dv, drh, drw = torch.autograd.grad(o, leaves, do)
        for name in ("flash_attention_relpos_fwd", "flash_attention_relpos_dq",
                     "flash_attention_relpos_dkv"):
            assert KERNEL_LAUNCHES[name] == before[name] + 1
        with torch.no_grad():
            delta = (do.float() * o.float()).sum(dim=-1)
            args = (q, k, v, rh, rw, do, lse, delta)
            want = (*flash_attention_relpos_dq_reference(*args),
                    *flash_attention_relpos_dkv_reference(*args))
        for name, g, w in zip(("dq", "drh", "drw", "dk", "dv"),
                              (dq, drh, drw, dk, dv), want):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(
                g.float(), w.float(), rtol=0, msg=f"{name} {bh, k_h, k_w, d}",
                atol=_grad_atol(w, w.dtype))


def test_relpos_gradients_survive_checkpointing_on_card():
    """Under ``torch.utils.checkpoint`` the forward kernel runs twice and
    the gradients equal those without it."""
    from torch.utils.checkpoint import checkpoint
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 64, 32, device="cuda", generator=g)
               .requires_grad_() for _ in range(3))
    rh, rw = (torch.randn(2, 64, 8, device="cuda", generator=g)
              .requires_grad_() for _ in range(2))
    leaves = (q, k, v, rh, rw)
    want = torch.autograd.grad(flash_attention_relpos(*leaves)[0].sum(),
                               leaves)
    before = KERNEL_LAUNCHES["flash_attention_relpos_fwd"]
    out = checkpoint(lambda *a: flash_attention_relpos(*a)[0], *leaves,
                     use_reentrant=False)
    got = torch.autograd.grad(out.sum(), leaves)
    assert KERNEL_LAUNCHES["flash_attention_relpos_fwd"] == before + 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
