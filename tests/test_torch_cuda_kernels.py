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
from simpleaicv_tpu_torch.ops import msda

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


# (B, Lq, H, D, levels, P, location range): DINO-DETR's decoder launch at a
# small batch, D 8 and 48 (a second channel per lane), five levels with a
# 16x16 tail, locations off the map
MSDA_SHAPES = [
    (2, 1100, 8, 32, ((64, 64), (32, 32), (16, 16), (8, 8), (4, 4)), 4,
     (0.0, 1.0)),
    (2, 50, 4, 8, ((8, 8), (4, 4)), 3, (-0.1, 1.1)),
    (1, 77, 8, 48, ((32, 32), (16, 16), (8, 8), (4, 4), (16, 16)), 4,
     (-0.2, 1.2)),
]


def _msda_inputs(rng, b, lq, h, d, shapes, p, lo, hi):
    s = sum(hh * ww for hh, ww in shapes)
    value = _randn(rng, b, s, h, d).cuda()
    loc = torch.from_numpy(rng.uniform(lo, hi, (b, lq, h, len(shapes), p, 2))
                           .astype(np.float32)).cuda()
    wts = torch.from_numpy(rng.rand(b, lq, h, len(shapes), p)
                           .astype(np.float32)).cuda()
    return value, loc, wts


def _assert_rel(got, want, tol, what):
    """max |got - want| within ``tol`` of want's largest value: the location
    gradients carry factors of w_l and h_l, and grad_value's atomic adds
    come in another order on every run."""
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    assert err <= tol * scale, f"{what}: {err} of {scale}"


def test_msda_kernels_match_plain_versions_on_card():
    """K7 and K7b through autograd against the plain version and its
    autograd on the same inputs: output, value, location and weight
    gradients within 1e-5 of each tensor's largest value."""
    for i, (b, lq, h, d, shapes, p, (lo, hi)) in enumerate(MSDA_SHAPES):
        rng = np.random.RandomState(i)
        leaves = [t.requires_grad_() for t in _msda_inputs(
            rng, b, lq, h, d, shapes, p, lo, hi)]
        g_out = _randn(rng, b, lq, h * d).cuda()
        before = dict(msda.KERNEL_LAUNCHES)
        out = msda.ms_deform_attn(leaves[0], shapes, *leaves[1:])
        grads = torch.autograd.grad(out, leaves, g_out)
        assert msda.KERNEL_LAUNCHES == {k: v + 1 for k, v in before.items()}
        want = msda.ms_deform_attn_reference(leaves[0], shapes, *leaves[1:])
        want_grads = msda.ms_deform_attn_backward_reference(
            *(t.detach() for t in leaves[:1]), shapes,
            *(t.detach() for t in leaves[1:]), g_out)
        _assert_rel(out.detach(), want.detach(), 1e-5, f"out {i}")
        for name, g, w in zip(("value", "loc", "weights"), grads,
                              want_grads):
            assert g.shape == w.shape and g.dtype == torch.float32
            _assert_rel(g, w, 1e-5, f"grad {name} {i}")


def test_msda_gradients_survive_checkpointing_on_card():
    """Under ``torch.utils.checkpoint`` K7 runs twice; the location and
    weight gradients equal those without it, and the value gradient, summed
    by atomic adds in no fixed order, agrees to rounding."""
    from torch.utils.checkpoint import checkpoint
    shapes = ((16, 16), (8, 8))
    rng = np.random.RandomState(7)
    leaves = [t.requires_grad_() for t in _msda_inputs(
        rng, 2, 40, 8, 32, shapes, 4, 0.0, 1.0)]
    want = torch.autograd.grad(
        msda.ms_deform_attn(leaves[0], shapes, *leaves[1:]).square().sum(),
        leaves)
    before = dict(msda.KERNEL_LAUNCHES)
    out = checkpoint(lambda *a: msda.ms_deform_attn(a[0], shapes, *a[1:]),
                     *leaves, use_reentrant=False)
    got = torch.autograd.grad(out.square().sum(), leaves)
    assert msda.KERNEL_LAUNCHES == {"msda_fwd": before["msda_fwd"] + 2,
                                    "msda_bwd": before["msda_bwd"] + 1}
    _assert_rel(got[0], want[0], 1e-6, "grad value")
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_msda_launch_raises_for_wide_heads_on_card():
    """D > 64 has no kernel: the wrapper raises, and launches nothing."""
    shapes = ((4, 4),)
    value = torch.zeros(1, 16, 1, 65, device="cuda")
    loc = torch.zeros(1, 2, 1, 1, 1, 2, device="cuda")
    wts = torch.zeros(1, 2, 1, 1, 1, device="cuda")
    before = dict(msda.KERNEL_LAUNCHES)
    with pytest.raises(ValueError, match="D <= 64"):
        msda.ms_deform_attn(value, shapes, loc, wts)
    assert msda.KERNEL_LAUNCHES == before
