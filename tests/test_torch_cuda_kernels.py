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
    KERNEL_LAUNCHES, NARROW_LAUNCHES, flash_attention,
    flash_attention_backward_reference, flash_attention_dkv_reference,
    flash_attention_dq_reference,
    flash_attention_reference, flash_attention_relpos,
    flash_attention_relpos_dkv_reference, flash_attention_relpos_dq_reference,
    flash_attention_relpos_reference)
from simpleaicv_tpu_torch.ops import flash_attention as fa_ops
from simpleaicv_tpu_torch.ops import msda
from simpleaicv_tpu_torch.perf import bw_probe, matmul_probe

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


def _unaligned(t, offset=2):
    """A copy of ``t`` whose storage starts ``offset`` elements into its
    buffer: its rows are 4-byte but not 16-byte aligned."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


# (BH, k_h, k_w, d) at the edges of the forward kernel's tiles: BH no
# multiple of anything, k_w padded to 16 or 64, d padded to 32, 64, 80 or
# 128, N no multiple of the 128-query block
RELPOS_FWD_EDGES = [(3, 6, 10, 32), (5, 8, 14, 40), (3, 16, 16, 64),
                    (5, 4, 64, 80), (3, 8, 64, 128), (5, 10, 10, 64),
                    (3, 3, 64, 40)]


@pytest.mark.parametrize("bh,k_h,k_w,d", RELPOS_FWD_EDGES)
def test_relpos_forward_tiling_edges_on_card(bh, k_h, k_w, d):
    """The bf16 rel-pos forward (wgmma) and its narrow variant (mma.sync,
    4-byte copies, for rows that are not 16-byte aligned) against the plain
    version, one launch each."""
    rng = np.random.RandomState(bh * 100 + k_w)
    n = k_h * k_w
    q, k, v = (_randn(rng, bh, n, d).to("cuda", torch.bfloat16)
               for _ in range(3))
    rh, rw = _randn(rng, bh, n, k_h).cuda(), _randn(rng, bh, n, k_w).cuda()
    o_ref, lse_ref = flash_attention_relpos_reference(q, k, v, rh, rw)
    for args in ((q, k, v), tuple(_unaligned(t) for t in (q, k, v))):
        launches = KERNEL_LAUNCHES["flash_attention_relpos_fwd"]
        o, lse = flash_attention_relpos(*args, rh, rw)
        assert KERNEL_LAUNCHES["flash_attention_relpos_fwd"] == launches + 1
        torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-2,
                                   rtol=0)
        torch.testing.assert_close(lse, lse_ref, atol=2e-2, rtol=0)


# (B, H, N, d) at the edges of the forward's tiling: token counts below,
# at and past the 64-row tiles and the 256-row items, at every padded head
# width; one head, 133 heads (no multiple of the persistent grid) and
# ViT-B/16's 1536 at batch 128
FLASH_FWD_EDGES = ([(2, 3, n, d)
                    for n in (1, 5, 16, 17, 64, 65, 128, 129, 197, 208, 257,
                              300) for d in (40, 64, 80, 128)]
                   + [(1, 1, 197, 64), (7, 19, 197, 64), (128, 12, 197, 64)])


@pytest.mark.parametrize("b,h,n,d", FLASH_FWD_EDGES)
def test_flash_forward_tiling_edges_on_card(b, h, n, d):
    """The bf16 flash forward on q, k, v sliced from one fused projection,
    through the persistent wgmma kernel for d <= 64 and the mma.sync one
    with 16-byte copies for d 80 and 128, without a narrow launch."""
    rng = np.random.RandomState(n + d + b * h)
    qkv = _randn(rng, b, n, 3, h, d).to("cuda", torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert fa_ops._flash_fwd_variant(q, k, v) == ("tma" if d <= 64
                                                  else "wide_sync")
    launches = KERNEL_LAUNCHES["flash_attention_fwd"]
    narrow = NARROW_LAUNCHES["flash_attention_fwd"]
    o = flash_attention(q, k, v)
    assert KERNEL_LAUNCHES["flash_attention_fwd"] == launches + 1
    assert NARROW_LAUNCHES["flash_attention_fwd"] == narrow
    o_ref, _ = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=8e-3, rtol=0)


@pytest.mark.parametrize("offset", [2, 4])
def test_flash_forward_unaligned_view_on_card(offset):
    """A fused projection 4 or 8 bytes off 16-byte alignment: the forward
    takes its narrow variant (4-byte copies) and still matches."""
    rng = np.random.RandomState(offset)
    qkv = _unaligned(_randn(rng, 2, 197, 3, 12, 64).to("cuda",
                                                       torch.bfloat16),
                     offset)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    assert not fa_ops._vector_loads(q, k, v)
    launches = KERNEL_LAUNCHES["flash_attention_fwd"]
    o = flash_attention(q, k, v)
    assert KERNEL_LAUNCHES["flash_attention_fwd"] == launches + 1
    o_ref, _ = flash_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=8e-3, rtol=0)


def test_forward_kernels_repeat_bitwise_on_card():
    """No atomics: two launches of K4 and of K1 give the same bits, K1
    through its persistent kernel at a head count no multiple of the grid
    and at a token count past one item."""
    rng = np.random.RandomState(5)
    q, k, v = (_randn(rng, 3, 1024, 64).to("cuda", torch.bfloat16)
               for _ in range(3))
    rh, rw = _randn(rng, 3, 1024, 32).cuda(), _randn(rng, 3, 1024, 32).cuda()
    first, second = (flash_attention_relpos(q, k, v, rh, rw)
                     for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for b, h, n in ((4, 12, 197), (7, 19, 300)):
        qkv = _randn(rng, b, n, 3, h, 64).to("cuda", torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        assert fa_ops._flash_fwd_variant(q, k, v) == "tma"
        first, second = (fa_ops._flash_fwd_cuda(q, k, v) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


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


def _flash_bwd_inputs(rng, b, h, n, d, offset=0, fused=True):
    """(q, k, v, dO, lse, delta) in bf16 as the backward gets them: q, k, v
    [B, H, N, d] views of one fused [B, N, 3, H, d] projection whose storage
    starts ``offset`` elements into its buffer (or, not ``fused``, three
    contiguous [B, H, N, d] tensors), dO a view of [B, N, H, d] storage,
    lse from the plain forward and delta = rowsum(dO * o) in f32."""
    if fused:
        qkv = _randn(rng, b, n, 3, h, d).to("cuda", torch.bfloat16)
        if offset:
            qkv = _unaligned(qkv, offset)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    else:
        q, k, v = (_randn(rng, b, h, n, d).to("cuda", torch.bfloat16)
                   for _ in range(3))
    do = _randn(rng, b, n, h, d).to("cuda", torch.bfloat16).transpose(1, 2)
    o, lse = flash_attention_reference(q, k, v)
    delta = (do.float() * o.float()).sum(dim=-1)
    return q, k, v, do, lse, delta


def _flash_bwd_launch(args):
    return (fa_ops._flash_dq_cuda(*args), *fa_ops._flash_dkv_cuda(*args))


def _check_flash_bwd(args, variant):
    """One launch of K2 and of K3 through ``variant`` against the plain
    versions on the same inputs, dq, dk, dv within ``_grad_atol``. At N 1
    the softmax runs over one key, so dq and dk are 0: the plain version
    and the kernels both give the f32 rounding of dP - delta (1e-9 and
    1e-7 of inputs near 1), which two bf16 steps at that largest value do
    not resolve; there they are held to the f32 tolerance, 1e-4."""
    assert fa_ops._flash_bwd_variant(*args[:4]) == variant
    before, narrow_before = dict(KERNEL_LAUNCHES), dict(NARROW_LAUNCHES)
    got = _flash_bwd_launch(args)
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        assert KERNEL_LAUNCHES[name] == before[name] + 1
        assert NARROW_LAUNCHES[name] == (narrow_before[name]
                                         + (variant == "narrow"))
    want = (flash_attention_dq_reference(*args),
            *flash_attention_dkv_reference(*args))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        one_key = args[0].shape[-2] == 1 and name != "dv"
        atol = 1e-4 if one_key else _grad_atol(w, w.dtype)
        torch.testing.assert_close(g.float(), w.float(), rtol=0, msg=name,
                                   atol=atol)


# (B, H, N, d, fused) at the edges of the backward's tiling: token counts
# below, at and past the 64-row tiles of the other side (tails of 1 to 63
# rows) and the 128-row items, at a padded and the full head width; one
# head, 133 heads (no multiple of the persistent grid) and ViT-B/16's 1536
# at batch 128; and three contiguous [B, H, N, d] tensors in place of the
# fused projection
FLASH_BWD_EDGES = ([(2, 3, n, d, True)
                    for n in (1, 5, 16, 17, 64, 65, 128, 129, 197, 208, 257,
                              300) for d in (40, 64)]
                   + [(1, 1, 197, 64, True), (7, 19, 197, 64, True),
                      (128, 12, 197, 64, True), (2, 3, 197, 64, False)])


@pytest.mark.parametrize("b,h,n,d,fused", FLASH_BWD_EDGES)
def test_flash_backward_tiling_edges_on_card(b, h, n, d, fused):
    """K2 and K3 at the edges of their tiling, through the persistent wgmma
    kernels fed by TMA, without a narrow launch."""
    rng = np.random.RandomState(b * h + n + d)
    _check_flash_bwd(_flash_bwd_inputs(rng, b, h, n, d, fused=fused), "tma")


@pytest.mark.parametrize("b,h,n,d,offset", [(1, 16, 257, 80, 0),
                                            (1, 2, 130, 128, 0),
                                            (2, 12, 197, 64, 2)])
def test_flash_backward_narrow_variants_on_card(b, h, n, d, offset):
    """d 80 (ViT-H) and 128, and a fused projection 4 bytes off 16-byte
    alignment, take the narrow kernels (mma.sync) and match."""
    rng = np.random.RandomState(d + offset)
    _check_flash_bwd(_flash_bwd_inputs(rng, b, h, n, d, offset), "narrow")


def test_flash_backward_kernels_repeat_bitwise_on_card():
    """No atomics: two launches of K2 and of K3 give the same bits, through
    the wgmma kernels and through the narrow ones."""
    rng = np.random.RandomState(7)
    for offset, variant in ((0, "tma"), (2, "narrow")):
        args = _flash_bwd_inputs(rng, 2, 12, 197, 64, offset)
        assert fa_ops._flash_bwd_variant(*args[:4]) == variant
        first, second = (_flash_bwd_launch(args) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


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


def _by_heads(plain_fn, args, chunk=16):
    """The plain version ``chunk`` heads at a time, the outputs joined: its
    f32 [BH, N, N] tensors would crowd the card at 96 heads of SAM-B. The
    heads are independent, so the result is the plain version's own."""
    outs = [plain_fn(*(a[i:i + chunk] for a in args))
            for i in range(0, args[0].shape[0], chunk)]
    return tuple(torch.cat(col) for col in zip(*outs))


def _relpos_bwd_inputs(rng, bh, k_h, k_w, d, offset=0):
    """(q, k, v, rel_h, rel_w, dO, lse, delta) in bf16 as the backward gets
    them; q, k, v and dO start ``offset`` elements into their buffers."""
    n = k_h * k_w
    q, k, v, do = (_randn(rng, bh, n, d).to("cuda", torch.bfloat16)
                   for _ in range(4))
    rh, rw = _randn(rng, bh, n, k_h).cuda(), _randn(rng, bh, n, k_w).cuda()
    o, lse = flash_attention_relpos(q, k, v, rh, rw)
    delta = (do.float() * o.float()).sum(dim=-1)
    if offset:
        q, k, v, do = (_unaligned(t, offset) for t in (q, k, v, do))
    return q, k, v, rh, rw, do, lse, delta


def _relpos_bwd_launch(args):
    return (*fa_ops._flash_relpos_dq_cuda(*args),
            *fa_ops._flash_relpos_dkv_cuda(*args))


def _check_relpos_bwd(args, variant):
    """One launch of K5 and of K6 through ``variant`` against the plain
    versions on the same inputs: bf16 dq, dk, dv within ``_grad_atol``, the
    f32 drh and drw within 1e-4."""
    q, k, v, _, rw, do = args[:6]
    assert fa_ops._relpos_bwd_variant(q, k, v, do, rw) == variant
    before, narrow_before = dict(KERNEL_LAUNCHES), dict(NARROW_LAUNCHES)
    got = _relpos_bwd_launch(args)
    for name in ("flash_attention_relpos_dq", "flash_attention_relpos_dkv"):
        assert KERNEL_LAUNCHES[name] == before[name] + 1
        assert NARROW_LAUNCHES[name] == (narrow_before[name]
                                         + (variant == "narrow"))
    want = (*_by_heads(flash_attention_relpos_dq_reference, args),
            *_by_heads(flash_attention_relpos_dkv_reference, args))
    for name, g, w in zip(("dq", "drh", "drw", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=0, msg=name,
                                   atol=_grad_atol(w, w.dtype))


# (BH, k_h, k_w, d) at the edges of the backward's tiling: SAM-B's global
# layer at a training batch of 8 and for one image, one head with an odd
# number of 128-query (K5) and 128-key (K6) tiles, the widths past 64 and
# the key rows below 64 that take the narrow kernels
RELPOS_BWD_EDGES = [(96, 64, 64, 64), (12, 64, 64, 64), (1, 3, 64, 64),
                    (2, 8, 64, 80), (2, 8, 64, 128), (3, 6, 10, 64),
                    (3, 8, 16, 64), (2, 8, 24, 64)]


@pytest.mark.parametrize("bh,k_h,k_w,d", RELPOS_BWD_EDGES)
def test_relpos_backward_tiling_edges_on_card(bh, k_h, k_w, d):
    """K5 and K6 at the edges of their tiling: the wgmma kernels fed by TMA
    where k_w is 64 and d at most 64, the narrow kernels elsewhere."""
    rng = np.random.RandomState(bh * 100 + k_w + d)
    _check_relpos_bwd(_relpos_bwd_inputs(rng, bh, k_h, k_w, d),
                      "tma" if k_w == 64 and d <= 64 else "narrow")


@pytest.mark.parametrize("bh,k_h,k_w,d,offset", [(3, 8, 64, 64, 2),
                                                 (5, 8, 14, 42, 0)])
def test_relpos_backward_narrow_variants_on_card(bh, k_h, k_w, d, offset):
    """Rows 4 bytes off 16-byte alignment, and a d that is no multiple of
    8, take the narrow kernels (mma.sync, 4-byte staging) and match."""
    rng = np.random.RandomState(d + offset)
    _check_relpos_bwd(_relpos_bwd_inputs(rng, bh, k_h, k_w, d, offset),
                      "narrow")


def test_relpos_backward_kernels_repeat_bitwise_on_card():
    """No atomics: two launches of K5 and of K6 give the same bits, through
    the TMA kernels and through the narrow ones."""
    rng = np.random.RandomState(6)
    for offset, variant in ((0, "tma"), (2, "narrow")):
        args = _relpos_bwd_inputs(rng, 3, 5, 64, 64, offset)
        q, k, v, _, rw, do = args[:6]
        assert fa_ops._relpos_bwd_variant(q, k, v, do, rw) == variant
        first, second = (_relpos_bwd_launch(args) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


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


def _msda_inputs(rng, b, lq, h, d, shapes, p, lo, hi, where="uniform"):
    """value, locations and weights on the card. Locations (``where``):
    uniform in [lo, hi]; on cell centres ("centres"); around each query's
    own cell, the queries a grid over every level as in DINO-DETR's encoder
    ("grid", lq = S); or inside random boxes ("boxes", the decoder's)."""
    s = sum(hh * ww for hh, ww in shapes)
    value = _randn(rng, b, s, h, d).cuda()
    loc = rng.uniform(lo, hi, (b, lq, h, len(shapes), p, 2))
    wh = np.array([[ww, hh] for hh, ww in shapes])[None, None, None, :,
                                                     None]
    if where == "centres":
        loc = (np.maximum(np.floor(loc * wh), 0) + 0.5) / wh
    elif where == "grid":
        centres = np.concatenate([
            np.stack(np.meshgrid((np.arange(ww) + 0.5) / ww,
                                 (np.arange(hh) + 0.5) / hh), -1).reshape(
                -1, 2) for hh, ww in shapes])
        loc = centres[None, :, None, None, None] + 4 * (loc - 0.5) / wh
    elif where == "boxes":
        box = rng.rand(b, lq, 1, 1, 1, 4)
        loc = box[..., :2] + (loc - 0.5) * (0.05 + 0.3 * box[..., 2:])
    loc = torch.from_numpy(loc.astype(np.float32)).cuda()
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


def _check_msda_bwd(value, shapes, loc, wts, g_out, variant):
    """One K7b launch through ``variant`` against the plain backward on the
    same inputs, each gradient within 1e-5 of its largest value, a narrow
    launch counted exactly when the variant is the narrow one; a second
    launch gives the same location and weight gradients."""
    assert msda._msda_bwd_variant(value, shapes, loc) == variant
    before, narrow = msda.KERNEL_LAUNCHES["msda_bwd"], \
        msda.NARROW_LAUNCHES["msda_bwd"]
    got = msda._msda_bwd_cuda(value, shapes, loc, wts, g_out)
    assert msda.KERNEL_LAUNCHES["msda_bwd"] == before + 1
    assert msda.NARROW_LAUNCHES["msda_bwd"] == narrow + (variant == "narrow")
    want = msda.ms_deform_attn_backward_reference(value, shapes, loc, wts,
                                                  g_out)
    for name, g, w in zip(("value", "loc", "weights"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _assert_rel(g, w, 1e-5, f"grad {name}")
    again = msda._msda_bwd_cuda(value, shapes, loc, wts, g_out)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


DINO_LEVELS = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))

# (B, Lq, H, D, levels, P, location range, where): queries on a grid over
# the levels sampling around their own cells (DINO-DETR's encoder), random
# boxes (its decoder), locations off the map and on cell centres, one level,
# levels of DINO-DETR's size and larger, B 1 and 2, query counts that no
# chunk divides, D 4 to 64
MSDA_TILED_EDGES = [
    (2, 1360, 8, 32, ((32, 32), (16, 16), (8, 8), (4, 4)), 4, (0.0, 1.0),
     "grid"),
    (1, 1100, 8, 32, ((64, 64), (32, 32), (16, 16)), 4, (0.0, 1.0), "boxes"),
    (2, 77, 4, 16, ((32, 32), (16, 16), (8, 8), (4, 4), (16, 16)), 4,
     (-0.1, 1.1), "uniform"),
    (2, 40, 8, 32, ((12, 10), (5, 7), (16, 16)), 4, (-0.1, 1.1), "centres"),
    (1, 50, 8, 32, ((16, 16),), 4, (0.0, 1.0), "uniform"),
    (1, 301, 8, 32, DINO_LEVELS, 4, (-0.1, 1.1), "uniform"),
    (1, 3001, 2, 32, ((96, 96), (72, 72)), 4, (0.0, 1.0), "uniform"),
    (2, 33, 3, 8, ((7, 9), (3, 3), (5, 5)), 5, (-0.1, 1.1), "uniform"),
    (2, 40, 8, 48, ((12, 10), (5, 7)), 4, (-0.1, 1.1), "uniform"),
    (1, 65, 2, 64, ((20, 20), (10, 10)), 4, (0.0, 1.0), "uniform"),
    (1, 9, 1, 4, ((6, 5),), 2, (0.0, 1.0), "uniform"),
]


@pytest.mark.parametrize("b,lq,h,d,shapes,p,bounds,where", MSDA_TILED_EDGES)
def test_msda_backward_tiled_edges_on_card(b, lq, h, d, shapes, p, bounds,
                                           where):
    """K7b through its tiled kernel at the edges of its layout against the
    plain backward."""
    rng = np.random.RandomState(lq + d)
    value, loc, wts = _msda_inputs(rng, b, lq, h, d, shapes, p, *bounds,
                                   where)
    g_out = _randn(rng, b, lq, h * d).cuda()
    _check_msda_bwd(value, shapes, loc, wts, g_out, "tiled")


@pytest.mark.parametrize("d,n_levels,p,offset", [(6, 2, 4, 0), (10, 3, 4, 0),
                                                 (32, 4, 9, 0), (32, 2, 4, 1),
                                                 (48, 2, 4, 1)])
def test_msda_backward_narrow_variant_on_card(d, n_levels, p, offset):
    """What the tiled kernel does not take goes to the narrow one (a warp
    per (b, q, h), lane = channel) and matches: D no multiple of 4, more
    than 32 samples a (query, head), a value 4 bytes off 16-byte
    alignment."""
    rng = np.random.RandomState(d + p + offset)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))[:n_levels]
    value, loc, wts = _msda_inputs(rng, 2, 30, 4, d, shapes, p, -0.1, 1.1)
    if offset:
        value = _unaligned(value, offset)
    g_out = _randn(rng, 2, 30, 4 * d).cuda()
    _check_msda_bwd(value, shapes, loc, wts, g_out, "narrow")


def _check_msda_fwd(value, shapes, loc, wts, variant):
    """Two K7 launches through ``variant`` against the plain forward on the
    same inputs, within 1e-5 of its largest value, narrow launches counted
    exactly when the variant is the narrow one, the same bits from both."""
    assert msda._msda_fwd_variant(value, shapes, loc) == variant
    before, narrow = msda.KERNEL_LAUNCHES["msda_fwd"], \
        msda.NARROW_LAUNCHES["msda_fwd"]
    got = msda._msda_fwd_cuda(value, shapes, loc, wts)
    again = msda._msda_fwd_cuda(value, shapes, loc, wts)
    assert msda.KERNEL_LAUNCHES["msda_fwd"] == before + 2
    assert msda.NARROW_LAUNCHES["msda_fwd"] == narrow + 2 * (
        variant == "narrow")
    want = msda.ms_deform_attn_reference(value, shapes, loc, wts)
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_rel(got, want, 1e-5, "out")
    assert torch.equal(got, again)


@pytest.mark.parametrize("b,lq,h,d,shapes,p,bounds,where", MSDA_TILED_EDGES)
def test_msda_forward_tiled_edges_on_card(b, lq, h, d, shapes, p, bounds,
                                          where):
    """K7 through its tiled kernel at the edges of its layout against the
    plain forward (the first case's queries are the levels' cells, which
    the kernel walks in 8 x 8 patches)."""
    rng = np.random.RandomState(lq + d + 1)
    value, loc, wts = _msda_inputs(rng, b, lq, h, d, shapes, p, *bounds,
                                   where)
    _check_msda_fwd(value, shapes, loc, wts, "tiled")


@pytest.mark.parametrize("d,n_levels,p,offset", [(6, 2, 4, 0), (10, 3, 4, 0),
                                                 (32, 4, 9, 0), (32, 2, 4, 1),
                                                 (48, 2, 4, 1)])
def test_msda_forward_narrow_variant_on_card(d, n_levels, p, offset):
    """What the tiled forward does not take goes to the narrow one (a warp
    per (b, q, h), lane = channel) and matches: D no multiple of 4, more
    than 32 samples a (query, head), a value 4 bytes off 16-byte
    alignment."""
    rng = np.random.RandomState(d + p + offset + 1)
    shapes = ((8, 8), (4, 4), (2, 2), (1, 1))[:n_levels]
    value, loc, wts = _msda_inputs(rng, 2, 30, 4, d, shapes, p, -0.1, 1.1)
    if offset:
        value = _unaligned(value, offset)
    _check_msda_fwd(value, shapes, loc, wts, "narrow")


@pytest.mark.parametrize("shapes,d", [
    (((13, 11), (7, 5), (3, 2)), 32),    # patches cut at every level's edge
    (((64, 64), (32, 32), (16, 16), (8, 8), (4, 4)), 32),
    (((9, 17), (5, 9)), 16)])
def test_msda_forward_cell_walk_on_card(shapes, d):
    """Queries that are the levels' cells (Lq = S, DINO-DETR's encoder),
    each sampling around its own cell: the tiled forward walks them in 8 x 8
    patches of a level, the last ones cut at the level's edge."""
    s = sum(hh * ww for hh, ww in shapes)
    rng = np.random.RandomState(s + d)
    value, loc, wts = _msda_inputs(rng, 2, s, 8, d, shapes, 4, 0.0, 1.0,
                                   "grid")
    _check_msda_fwd(value, shapes, loc, wts, "tiled")


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


def _mm_bound(x, w, want):
    """How far a bf16 product may lie from the f32 product ``want``: one
    bf16 spacing at each element's magnitude, plus the f32 sum's own
    rounding in another order (K * 2^-24 * sum |x w|), which matters where
    the terms cancel."""
    spacing = torch.exp2(torch.floor(torch.log2(want.abs() + 1e-30)) - 7)
    return spacing + x.shape[1] * 2.0**-24 * (x.float().abs()
                                             @ w.float().abs())


@pytest.mark.parametrize("m,k,n", [(401408, 64, 256), (100352, 128, 512),
                                   (1000, 64, 256), (77, 16, 64),
                                   (300, 48, 128)])
def test_probe_mm_matches_plain_version_on_card(m, k, n):
    """P1 and P2 at ResNet-50's layer-1 and layer-2 shapes and at ragged M
    (1000, 77 and 300 rows: no multiple of the 128-row tile). The bf16
    output lies within one bf16 spacing of the f32 product at each
    element's magnitude (``_mm_bound``); the column sums within 1e-5 of
    their largest value (f32 sums in another order)."""
    x, w = matmul_probe.probe_inputs(m, k, n, seed=m)
    want = x.float() @ w.float()
    before = dict(matmul_probe.KERNEL_LAUNCHES)
    y = matmul_probe.probe_mm(x, w)
    y2, s1, s2 = matmul_probe.probe_mm(x, w, stats=True)
    torch.cuda.synchronize()
    assert matmul_probe.KERNEL_LAUNCHES == {
        "probe_mm": before["probe_mm"] + 1,
        "probe_mm_stats": before["probe_mm_stats"] + 1}
    for got in (y, y2):
        assert got.shape == (m, n) and got.dtype == torch.bfloat16
        assert bool(((got.float() - want).abs()
                     <= _mm_bound(x, w, want)).all())
    for got, ref in [(s1, want.sum(0, keepdim=True)),
                     (s2, want.square().sum(0, keepdim=True))]:
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


def test_probe_mm_stats_are_reproducible_on_card():
    """No atomics: two P2 calls give the same bits, through its stream at
    ResNet-50's layer 2 (a fixed item walk and fixed-order reduces)."""
    x, w = matmul_probe.probe_inputs(100352, 128, 512)
    assert matmul_probe._mm_variant(x, w) == "stream"
    before = matmul_probe.NARROW_LAUNCHES["probe_mm_stats"]
    a = matmul_probe.probe_mm(x, w, stats=True)
    b = matmul_probe.probe_mm(x, w, stats=True)
    assert matmul_probe.NARROW_LAUNCHES["probe_mm_stats"] == before
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _check_mm_stats(x, w, got):
    """P2's (y, s1, s2) against ``mm_stats_plain``'s f32 product: y within
    one bf16 spacing (``_mm_bound``), the sums within 1e-5 of their
    largest value (f32 sums in another order)."""
    want = x.float() @ w.float()
    y, s1, s2 = got
    m, n = want.shape
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert bool(((y.float() - want).abs() <= _mm_bound(x, w, want)).all())
    _, s1_plain, s2_plain = matmul_probe.mm_stats_plain(x, w)
    for got_sum, ref in [(s1, s1_plain), (s2, s2_plain)]:
        assert got_sum.shape == (1, n) and got_sum.dtype == torch.float32
        err = (got_sum - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


P2_STREAM_CASES = [(401408, 64, 256),   # ResNet-50's layer 1
                   (100352, 128, 512),  # layer 2
                   (1000, 64, 256),     # a ragged M: 15.6 items
                   (300, 128, 192),     # ragged, 3 chunks of 64 columns
                   (4096, 64, 64),      # one chunk: the consumers take turns
                   (300, 128, 128),     # 5 items: fewer than SMs
                   (4096, 64, 512),     # 4 chunks at a ring of 6
                   (4096, 64, 384),     # 3 chunks of 128 columns
                   (777, 128, 448)]     # 7 chunks of 64 columns


@pytest.mark.parametrize("m,k,n", P2_STREAM_CASES)
def test_probe_mm_stats_stream_on_card(m, k, n):
    """P2's stream (P1's stream with the column sums in its epilogue) at
    ResNet-50's layers, ragged M, fewer items than SMs and N 64 to 512 (1
    to 7 chunks a consumer pair shares): against ``mm_stats_plain``, no
    narrow launch, and the same bits from a second launch."""
    x, w = matmul_probe.probe_inputs(m, k, n, seed=m + n)
    assert matmul_probe._mm_variant(x, w) == "stream"
    before = (matmul_probe.KERNEL_LAUNCHES["probe_mm_stats"],
              matmul_probe.NARROW_LAUNCHES["probe_mm_stats"])
    got = matmul_probe.probe_mm(x, w, stats=True)
    again = matmul_probe.probe_mm(x, w, stats=True)
    torch.cuda.synchronize()
    assert (matmul_probe.KERNEL_LAUNCHES["probe_mm_stats"],
            matmul_probe.NARROW_LAUNCHES["probe_mm_stats"]) == (
                before[0] + 2, before[1])
    _check_mm_stats(x, w, got)
    for u, v in zip(got, again):
        assert torch.equal(u, v)


@pytest.mark.parametrize("m,k,n,offset", [(300, 48, 128, 0),
                                          (1000, 64, 256, 2)])
def test_probe_mm_stats_narrow_variant_on_card(m, k, n, offset):
    """What P2's stream does not take goes to its narrow variant (the
    mma.sync kernel with per-block partials), counted, and matches: K 48,
    and x 4 bytes off 16-byte alignment; the same bits from a second
    launch."""
    x, w = matmul_probe.probe_inputs(m, k, n, seed=m + k)
    if offset:
        x = matmul_probe.offset_copy(x, offset)
    assert matmul_probe._mm_variant(x, w) == "narrow"
    before = matmul_probe.NARROW_LAUNCHES["probe_mm_stats"]
    got = matmul_probe.probe_mm(x, w, stats=True)
    torch.cuda.synchronize()
    assert matmul_probe.NARROW_LAUNCHES["probe_mm_stats"] == before + 1
    _check_mm_stats(x, w, got)
    for u, v in zip(got, matmul_probe.probe_mm(x, w, stats=True)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("shape", [(401408, 256), (1001, 3), (5,)])
def test_probe_scale_exact_on_card(shape):
    """P3 at the layer-1 activation, at a size with a tail of fewer than 8
    values, and below one vector: equal to the plain version."""
    x = torch.randn(shape, device="cuda").to(torch.bfloat16)
    before = bw_probe.KERNEL_LAUNCHES["probe_scale"]
    o = bw_probe.probe_scale(x)
    torch.cuda.synchronize()
    assert bw_probe.KERNEL_LAUNCHES["probe_scale"] == before + 1
    assert torch.equal(o, bw_probe.scale_plain(x))
    assert torch.equal(o, x)


def test_probe_mm_raises_for_shapes_it_does_not_take_on_card():
    x = torch.zeros(128, 40, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="K in 16..128"):
        matmul_probe.probe_mm(x, torch.zeros(40, 64, dtype=torch.bfloat16,
                                             device="cuda"))
    x = torch.zeros(128, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="N a multiple of 64"):
        matmul_probe.probe_mm(x, torch.zeros(64, 96, dtype=torch.bfloat16,
                                             device="cuda"))


P1_STREAM_CASES = [(401408, 64, 256),   # ResNet-50's layer 1
                   (100352, 128, 512),  # layer 2
                   (1000, 64, 256),     # a ragged M: 15.6 items
                   (300, 128, 128),     # 5 items: fewer than SMs
                   (4096, 64, 64), (4096, 128, 128), (4096, 64, 192),
                   (4096, 128, 512), (777, 128, 320)]


@pytest.mark.parametrize("m,k,n", P1_STREAM_CASES)
def test_probe_mm_stream_on_card(m, k, n):
    """P1's stream (persistent TMA + wgmma) at ResNet-50's layers, a ragged
    M, a launch of fewer items than SMs and N 64 to 512: within one bf16
    spacing of the f32 product (``_mm_bound``), no narrow launch, and the
    same bits from a second launch."""
    x, w = matmul_probe.probe_inputs(m, k, n, seed=m + n)
    assert matmul_probe._mm_variant(x, w) == "stream"
    want = x.float() @ w.float()
    before = (matmul_probe.KERNEL_LAUNCHES["probe_mm"],
              matmul_probe.NARROW_LAUNCHES["probe_mm"])
    y = matmul_probe.probe_mm(x, w)
    again = matmul_probe.probe_mm(x, w)
    torch.cuda.synchronize()
    assert (matmul_probe.KERNEL_LAUNCHES["probe_mm"],
            matmul_probe.NARROW_LAUNCHES["probe_mm"]) == (before[0] + 2,
                                                          before[1])
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert bool(((y.float() - want).abs() <= _mm_bound(x, w, want)).all())
    assert torch.equal(y, again)


@pytest.mark.parametrize("m,k,n,offset", [(77, 16, 64, 0),
                                          (300, 48, 128, 0),
                                          (1000, 64, 256, 2),
                                          (500, 128, 640, 0)])
def test_probe_mm_narrow_variant_on_card(m, k, n, offset):
    """What P1's stream does not take goes to its narrow variant (the
    mma.sync kernel) and matches: K 16 and 48, x 4 bytes off 16-byte
    alignment, N above 512."""
    x, w = matmul_probe.probe_inputs(m, k, n, seed=m + k)
    if offset:
        x = matmul_probe.offset_copy(x, offset)
    assert matmul_probe._mm_variant(x, w) == "narrow"
    want = x.float() @ w.float()
    before = matmul_probe.NARROW_LAUNCHES["probe_mm"]
    y = matmul_probe.probe_mm(x, w)
    torch.cuda.synchronize()
    assert matmul_probe.NARROW_LAUNCHES["probe_mm"] == before + 1
    assert bool(((y.float() - want).abs() <= _mm_bound(x, w, want)).all())
    assert torch.equal(y, matmul_probe.probe_mm(x, w))


def _detections(b, k, seed):
    """[b, k, 4] clustered xyxy boxes, [b, k] distinct scores, and DINO-DETR
    predictions for the decoder."""
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(20, 100, (b, 6, 2))[:, rng.randint(0, 6, k)] \
        + rng.randn(b, k, 2) * 6
    wh = rng.uniform(8, 60, (b, k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = np.stack([rng.permutation(k) for _ in range(b)]) / k + 0.001
    preds = {"pred_logits": rng.randn(b, k, 80) * 2 - 9,
             "pred_boxes": rng.uniform(0.05, 0.95, (b, k, 4))
             * np.array([1, 1, 0.5, 0.5])}
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)),
            {key: torch.from_numpy(v.astype(np.float32))
             for key, v in preds.items()})


@pytest.mark.parametrize("nms_type", ["python_nms", "diou_python_nms"])
def test_nms_and_dinodetr_decoder_on_card_equal_the_cpu(nms_type):
    """``batched_nms`` (the overlap matrix built on the card) and the
    DINO-DETR decoder at the recipe's settings (900 queries, top 300, 100
    kept, 80 classes) on CUDA tensors: the same keep sets, indices and
    classes as on the CPU; scores and boxes within 1e-6 relative (a
    sigmoid on the card may part from the CPU's by an ulp)."""
    from simpleaicv_tpu_torch.models.detection.dinodetr_decode import \
        DINODETRDecoder
    from simpleaicv_tpu_torch.ops.nms import batched_nms
    boxes, scores, preds = _detections(2, 900, seed=0)
    cpu = batched_nms(boxes[:, :150], scores[:, :150], 100, 0.5, nms_type)
    card = batched_nms(boxes[:, :150].cuda(), scores[:, :150].cuda(), 100,
                       0.5, nms_type)
    for got, want in zip(card, cpu):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert 0 < int(cpu[2].sum()) < 200

    decoder = DINODETRDecoder(num_classes=80, nms_type=nms_type)
    sizes = torch.tensor([[1024.0, 768.0], [640.0, 1024.0]])
    want = decoder(preds, sizes)
    got = decoder({k: v.cuda() for k, v in preds.items()}, sizes.cuda())
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-4)
    assert (want[0] > -1).any() and (want[0] == -1).any()


def _to(tree, device):
    """A nest of dicts, lists and tuples with its tensors on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


@pytest.mark.parametrize("top_k,batch", [(2, 16), (1, 4)])
def test_moe_index_dispatch_equals_the_one_hot_form_on_card(top_k, batch):
    """ViT-MoE-B/16's routing at 224^2 (197 tokens an image, 8 experts,
    capacity factor 1.25) on the card: the index dispatch's expert buffers
    equal the one-hot einsum's exactly, the combine to 1e-6 of its scale,
    and the slots the CPU's on the same probabilities."""
    from simpleaicv_tpu_torch.parallel import moe
    g = torch.Generator(device="cuda").manual_seed(batch)
    t, e, c = batch * 197, 8, 768
    layer = moe.MoEFeedForward(c, 4 * c, num_experts=e, top_k=top_k).cuda()
    cap = layer.capacity(t)
    probs = torch.softmax(3 * torch.randn(t, e, generator=g, device="cuda"),
                          -1)
    xt = torch.randn(t, c, generator=g, device="cuda").bfloat16()
    slots, gates, _ = moe.top_k_route(probs, cap, top_k)
    dispatch, combine, _ = moe.top_k_dispatch(probs, cap, top_k)
    cpu_slots, _, _ = moe.top_k_route(probs.cpu(), cap, top_k)
    for a, b in zip(slots, cpu_slots):
        assert torch.equal(a.cpu(), b)
    buffers = moe.dispatch(xt, slots, cap, e)
    want = torch.einsum("tec,td->ecd", dispatch, xt.float())
    assert torch.equal(buffers.float(), want)
    out = torch.randn(e * cap, c, generator=g, device="cuda")
    y = moe.combine(out, slots, gates)
    y_ref = torch.einsum("tec,ecd->td", combine, out.reshape(e, cap, c))
    torch.testing.assert_close(y, y_ref, atol=1e-6 * y_ref.abs().max(),
                               rtol=0)


def test_expert_product_backward_on_card_keeps_the_f32_gradient():
    """ViT-MoE-B/16's first expert product at batch 16 (8 experts, Cap 985,
    768 -> 3072) on bf16 operands: the card's backward, the f32 output
    gradient split into two bf16 parts, against the CPU's products of f32
    copies (JAX's transpose, unrounded): at most 2% of the bf16 gradients
    unequal, none by more than 2^-8 of their largest; a gradient rounded to
    bf16 first parts in about 40%."""
    from simpleaicv_tpu_torch.parallel import moe
    g = torch.Generator(device="cuda").manual_seed(11)
    a = torch.randn(8, 985, 768, generator=g, device="cuda").bfloat16()
    b = (torch.randn(8, 768, 3072, generator=g, device="cuda")
         / 28).bfloat16()
    dy = torch.randn(8, 985, 3072, generator=g, device="cuda")
    grads = []
    for device in ("cuda", "cpu"):
        x, w = (v.to(device).detach().requires_grad_() for v in (a, b))
        moe._ExpertProduct.apply(x, w).backward(dy.to(device))
        grads.append((x.grad, w.grad))
    for got, ref in zip(*grads):
        got, ref = got.cpu().float(), ref.float()
        assert (got - ref).abs().max() <= 2 ** -8 * ref.abs().max()
        assert (got != ref).float().mean() <= 0.02


# pixels a rotated image may move (the bound that
# tests/test_torch_device_augment.py measures and holds on the CPU)
ROTATED_PX = 32


@pytest.mark.parametrize("policy", ["v0", "rand"])
def test_device_augment_on_card_equals_the_cpu(policy):
    """AutoAugment v0 or RandAugment(2, 9), erasing and mixup/cutmix on a
    uint8 batch at 224^2, the card's draws applied on the card and on the
    CPU: the augmented lattice off by more than one level only in rotated
    images (at most ROTATED_PX pixels each) and in at most 0.5% of the pixels in
    all, the final batch and labels to 1e-6 elsewhere."""
    from simpleaicv_tpu_torch.data import device_augment as dev
    aug = (dev.DeviceAutoAugment("v0") if policy == "v0"
           else dev.DeviceRandAugment(2, 9))
    g = torch.Generator(device="cuda").manual_seed(5)
    b = 32
    image = torch.randint(0, 256, (b, 224, 224, 3), generator=g,
                          device="cuda").to(torch.uint8)
    draws = aug.draw(b, g, "cuda")
    got = aug.apply(image.float(), draws)
    want = aug.apply(image.cpu().float(), _to(draws, "cpu"))
    rotated = torch.zeros(b, dtype=torch.bool)
    for apply, _, cls, kind in _to(draws["slots"], "cpu"):
        rotated |= apply & (cls == dev._CLS_GEOM) & (kind == dev._G_ROT)
    diff = (got.cpu() - want).abs()
    far = (diff > 1).any(-1).sum((1, 2))
    assert (far[~rotated] == 0).all(), far
    assert (far[rotated] <= ROTATED_PX).all(), far
    assert (diff > 0).any(-1).float().mean() <= 5e-3
    pipe = dev.DeviceAugmentPipeline(
        augment=aug, erasing=dev.DeviceRandomErasing(prob=0.25),
        mixupcutmix=dev.DeviceMixupCutmix(num_classes=1000))
    batch = {"image": image,
             "label": torch.randint(0, 1000, (b,), generator=g,
                                    device="cuda")}
    pdraws = pipe.draw(batch, g)
    out = pipe.apply(batch, pdraws)
    ref = pipe.apply(_to(batch, "cpu"), _to(pdraws, "cpu"))
    torch.testing.assert_close(out["label"].cpu(), ref["label"], atol=1e-6,
                               rtol=0)
    assert ((out["image"].cpu() - ref["image"]).abs() > 1e-6).float(
        ).mean() <= 5e-3


def _op_cases_on_card(dtype):
    """(operator, arguments) of the seven kernels' operators at small shapes
    on the card; the forwards' inputs require gradients so that opcheck
    also runs their autograd."""
    rng = np.random.RandomState(30)

    def t(*shape, grad=False, dt=dtype):
        return _randn(rng, *shape).to("cuda", dt).requires_grad_(grad)

    q, k, v = (t(1, 2, 72, 64, grad=True) for _ in range(3))
    o, lse = fa_ops._FLASH_FWD(q.detach(), k.detach(), v.detach())
    bh, n, d = 2, 256, 64
    rq, rk, rv = (t(bh, n, d, grad=True) for _ in range(3))
    rh, rw = (t(bh, n, 16, grad=True, dt=torch.float32) for _ in range(2))
    ro, rlse = fa_ops._RELPOS_FWD(*(x.detach() for x in (rq, rk, rv, rh, rw)))
    do = t(bh, n, d)
    relpos_bwd = (*(x.detach() for x in (rq, rk, rv, rh, rw)), do, rlse,
                  (do.float() * ro.float()).sum(-1))
    shapes = [8, 8, 4, 4]
    value = t(2, 80, 2, 32, grad=True, dt=torch.float32)
    loc = torch.rand(2, 30, 2, 2, 4, 2, device="cuda").requires_grad_()
    wts = torch.rand(2, 30, 2, 2, 4, device="cuda").requires_grad_()
    return [
        (fa_ops._FLASH_FWD, (q, k, v)),
        (fa_ops._FLASH_BWD, (q.detach(), k.detach(), v.detach(), o, lse,
                             t(1, 2, 72, 64))),
        (fa_ops._RELPOS_FWD, (rq, rk, rv, rh, rw)),
        (fa_ops._RELPOS_DQ, relpos_bwd),
        (fa_ops._RELPOS_DKV, relpos_bwd),
        (msda._MSDA_FWD, (value, loc, wts, shapes)),
        (msda._MSDA_BWD, (value.detach(), loc.detach(), wts.detach(),
                          t(2, 30, 64, dt=torch.float32), shapes)),
    ]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("index", range(7))
def test_opcheck_on_card(index, dtype):
    """Each operator's CUDA implementation (the kernel) against its fake
    one and its autograd registration, with dynamic shapes."""
    op, args = _op_cases_on_card(dtype)[index]
    results = torch.library.opcheck(op, args)
    assert all(r == "SUCCESS" for r in results.values()), results


@pytest.mark.parametrize("c,stride", [(256, 1), (64, 2)])
def test_dcnv2_through_k7_and_k7b_on_card_equals_the_plain_version(c,
                                                                    stride):
    """DCNv2 at a detection head's layout (heads of 32, one level, one
    point a query) through the tiled K7 and K7b, against the same inputs
    on the CPU's plain versions; no narrow launch."""
    from simpleaicv_tpu_torch.ops.dcnv2 import deform_conv2d
    rng = np.random.RandomState(31)
    h = w = 25
    ho = -(-h // stride)
    x = _randn(rng, 2, h, w, c)
    off = _randn(rng, 2, ho, ho, 18) * 2.5
    mask = torch.from_numpy(rng.rand(2, ho, ho, 9).astype(np.float32))
    kernel = _randn(rng, 3, 3, c, 32) * 0.05
    grad = _randn(rng, 2, ho, ho, 32)
    results = []
    for device in ("cpu", "cuda"):
        inputs = [a.detach().to(device).requires_grad_()
                  for a in (x, off, mask, kernel)]
        before = dict(msda.KERNEL_LAUNCHES), dict(msda.NARROW_LAUNCHES)
        out = deform_conv2d(*inputs, stride=stride)
        out.backward(grad.to(device))
        results.append([out.detach().cpu()]
                       + [a.grad.cpu() for a in inputs])
        if device == "cuda":
            assert msda.KERNEL_LAUNCHES["msda_fwd"] == before[0]["msda_fwd"] + 1
            assert msda.KERNEL_LAUNCHES["msda_bwd"] == before[0]["msda_bwd"] + 1
            assert msda.NARROW_LAUNCHES == before[1]
    for name, got, want in zip(("out", "x", "offsets", "mask", "kernel"),
                               results[1], results[0]):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * scale,
                                   msg=name)
