"""The port's plain flash attention (simpleaicv_tpu_torch.ops) against the
JAX package's: the Pallas kernels in interpret mode (forward and the custom
VJP's two backward kernels) and ``flash_attention_xla``, which pads and masks
any sequence length, in f32.

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
from simpleaicv_tpu_torch.ops import flash_attention as port_fa
from simpleaicv_tpu_torch.ops.flash_attention import (
    KERNEL_LAUNCHES, attention_recompute, flash_attention,
    flash_attention_backward_reference, flash_attention_reference,
    flash_attention_relpos)

ATOL_FWD = 1e-5   # f32 sums in another order
ATOL_GRAD = 1e-4


def _inputs(b, h, n, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, n, d).astype(np.float32) for _ in range(4)]


def _port_out_and_grads(fn, q, k, v, do):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = fn(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(do))
    return o.detach().numpy(), [g.numpy() for g in grads]


def _jax_out_and_grads(fn, q, k, v, do):
    o, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _agree(port, want):
    np.testing.assert_allclose(port[0], want[0], atol=ATOL_FWD)
    for g, w in zip(port[1], want[1]):
        np.testing.assert_allclose(g, w, atol=ATOL_GRAD)


@pytest.mark.parametrize("n", [128, 256])
def test_flash_matches_pallas_kernels(n):
    """Forward and dq, dk, dv against the Pallas kernels (interpret mode)."""
    arrs = _inputs(1, 2, n, 32, seed=n)
    want = _jax_out_and_grads(
        lambda q, k, v: jax_fa.flash_attention(q, k, v, interpret=True),
        *arrs)
    _agree(_port_out_and_grads(flash_attention, *arrs), want)


@pytest.mark.parametrize("n,d", [(197, 64), (50, 40), (5, 16)])
def test_flash_matches_xla_flash_at_any_length(n, d):
    arrs = _inputs(2, 2, n, d, seed=n)
    want = _jax_out_and_grads(jax_fa.flash_attention_xla, *arrs)
    _agree(_port_out_and_grads(flash_attention, *arrs), want)


@pytest.mark.parametrize("n", [197, 17])
def test_attention_recompute_matches_jax(n):
    arrs = _inputs(2, 2, n, 32, seed=n + 1)
    want = _jax_out_and_grads(jax_fa.attention_recompute_xla, *arrs)
    _agree(_port_out_and_grads(attention_recompute, *arrs), want)


@pytest.mark.parametrize("fn", [flash_attention, attention_recompute])
def test_backward_reference_equals_autograd_of_forward(fn):
    """The recompute backward from (q, k, v, o, lse) against autograd
    through the plain forward, in f32 (atol 1e-5)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 3, 37, 24, seed=5))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_reference(qa, ka, va)
    want = torch.autograd.grad(o, (qa, ka, va), do)
    got = flash_attention_backward_reference(q, k, v, o.detach(),
                                             lse.detach(), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    # and through the Function that wires the two together
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    via_fn = torch.autograd.grad(fn(qf, kf, vf), (qf, kf, vf), do)
    for g, w in zip(via_fn, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_flash_reads_strided_qkv_views():
    """q, k, v sliced from one fused projection, as ViT hands them over."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 19, 3, 2, 8).astype(np.float32))
    qkv.requires_grad_()
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    o = flash_attention(q, k, v)
    want = torch.nn.functional.scaled_dot_product_attention(
        *(t.detach().contiguous() for t in (q, k, v)))
    torch.testing.assert_close(o, want, atol=1e-5, rtol=0)
    o.sum().backward()
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad).all()


def test_flash_cpu_bf16_keeps_dtype_and_counts_no_launch():
    arrs = _inputs(1, 2, 50, 32, seed=7)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrs)
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    before = dict(KERNEL_LAUNCHES)
    o = flash_attention(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    assert KERNEL_LAUNCHES == before
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    want = _port_out_and_grads(flash_attention, *(t.detach().float().numpy()
                                                  for t in (q, k, v, do)))
    # bf16 keeps 8 bits of mantissa: values below 2 round within 2e-2
    np.testing.assert_allclose(o.detach().float().numpy(), want[0],
                               atol=2e-2)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2)


@pytest.mark.parametrize("fn", [flash_attention, attention_recompute])
def test_flash_rejects_bad_inputs(fn):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 9, 8, seed=0))
    with pytest.raises(ValueError):
        fn(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        fn(q, k[:, :, :5], v)
    with pytest.raises(TypeError):
        fn(q, k.bfloat16(), v)


def test_relpos_gradient_guard():
    """``flash_attention_relpos`` once refused inputs that need a gradient;
    it is differentiable now: the output carries a graph into all five
    arguments whatever subset needs a gradient, the row logsumexp carries
    none, and nothing is recorded under ``no_grad``."""
    assert not hasattr(port_fa, "_refuse_gradients")
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 8).astype(np.float32))
               .requires_grad_() for _ in range(3))
    rh, rw = (torch.from_numpy(rng.randn(1, 16, 4).astype(np.float32))
              for _ in range(2))
    o, lse = flash_attention_relpos(q, k, v, rh, rw)
    assert o.requires_grad and not lse.requires_grad
    dq, dk, dv = torch.autograd.grad(o.sum(), (q, k, v))
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    # only the bias tables need a gradient
    rh.requires_grad_(), rw.requires_grad_()
    o, _ = flash_attention_relpos(q.detach(), k.detach(), v.detach(), rh, rw)
    drh, drw = torch.autograd.grad(o.sum(), (rh, rw))
    assert drh.shape == rh.shape and drw.shape == rw.shape
    with torch.no_grad():
        o, _ = flash_attention_relpos(q, k, v, rh, rw)
    assert not o.requires_grad


def _offset_view(shape, offset, dtype=torch.bfloat16):
    """A [B, H, N, d] view of [B, N, H, d] storage that starts ``offset``
    elements into its buffer."""
    b, h, n, d = shape
    buf = torch.zeros(b * n * h * d + offset, dtype=dtype)
    return buf[offset:].view(b, n, h, d).transpose(1, 2)


@pytest.mark.parametrize("shape,offset,want", [
    ((2, 3, 5, 64), 0, True),     # the layout ViT hands over
    ((2, 3, 197, 40), 0, True),   # d 40: rows 80 bytes apart
    ((2, 3, 5, 64), 8, True),     # 16 bytes in: still aligned
    ((2, 3, 5, 64), 2, False),    # 4 bytes in
    ((2, 3, 5, 64), 4, False),    # 8 bytes in
    ((2, 3, 5, 42), 0, False),    # d no multiple of 8
])
def test_vector_or_narrow_loads(shape, offset, want):
    """The bf16 forward kernels move 16 bytes a thread only where every row
    is 16-byte aligned; other views take the 4-byte variant."""
    q = _offset_view(shape, offset)
    aligned = _offset_view(shape, 0)
    assert port_fa._vector_loads(q, aligned, aligned) is want
    assert port_fa._vector_loads(aligned, aligned, q) is want
    # f32 tensors never take the bf16 kernels' vector path
    assert not port_fa._vector_loads(_offset_view(shape, 0, torch.float32))
    # a contiguous [BH, N, d] tensor, as the rel-pos kernel takes it
    flat = torch.zeros(6, 16, shape[-1], dtype=torch.bfloat16)
    assert port_fa._vector_loads(flat) is (shape[-1] % 8 == 0)


@pytest.mark.parametrize("k_w,d,offset,dtype,want", [
    (64, 64, 0, torch.bfloat16, "tma"),     # SAM's global layers
    (64, 40, 0, torch.bfloat16, "tma"),     # d padded to 64 by TMA's zeros
    (64, 80, 0, torch.bfloat16, "narrow"),  # d past 64
    (16, 64, 0, torch.bfloat16, "narrow"),  # key rows below 64
    (64, 64, 2, torch.bfloat16, "narrow"),  # 4 bytes off 16-byte alignment
    (64, 64, 8, torch.bfloat16, "tma"),     # 16 bytes in: still aligned
    (64, 42, 0, torch.bfloat16, "narrow"),  # d no multiple of 8
    (64, 64, 0, torch.float32, "f32"),
])
def test_relpos_backward_variant(k_w, d, offset, dtype, want):
    """The rel-pos backward (K5, K6) picks its kernels from the shapes and
    the alignment of q, k, v and dO alone, as ``csrc/flash_relpos_bwd.cu``
    documents, and launches nothing to do so."""
    n = 2 * k_w

    def rows(off):
        buf = torch.zeros(3 * n * d + off, dtype=dtype)
        return buf[off:].view(3, n, d)

    aligned, moved = rows(0), rows(offset)
    rel_w = torch.zeros(3, n, k_w)
    before = dict(port_fa.KERNEL_LAUNCHES)
    for args in ((moved, aligned, aligned, aligned),
                 (aligned, aligned, aligned, moved)):
        assert port_fa._relpos_bwd_variant(*args, rel_w) == want
    assert port_fa.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype,d,offset,n,want", [
    (torch.bfloat16, 64, 0, 197, "tma"),     # ViT-B/16's layers
    (torch.bfloat16, 40, 0, 197, "tma"),     # d padded to 64 by TMA's zeros
    (torch.bfloat16, 64, 0, 1, "tma"),       # one token: a 1-row tile
    (torch.bfloat16, 64, 0, 300, "tma"),     # a 44-row last tile
    (torch.bfloat16, 80, 0, 257, "narrow"),  # ViT-H's d 80
    (torch.bfloat16, 128, 0, 197, "narrow"),  # d past 64
    (torch.bfloat16, 64, 2, 197, "narrow"),  # 4 bytes off 16-byte alignment
    (torch.bfloat16, 64, 8, 197, "tma"),     # 16 bytes in: still aligned
    (torch.bfloat16, 42, 0, 197, "narrow"),  # d no multiple of 8
    (torch.float32, 64, 0, 197, "f32"),
])
def test_flash_backward_variant(dtype, d, offset, n, want):
    """The flash backward (K2, K3) picks its kernels from the head width and
    the alignment of q, k, v and dO alone, as ``csrc/flash_bwd.cu``
    documents, and launches nothing to do so: each tensor a [B, H, N, d]
    view of a fused [B, N, 3, H, d] projection (dO of [B, N, H, d]), one of
    them ``offset`` elements into its buffer."""
    b, h = 2, 3

    def fused(off):
        buf = torch.zeros(b * n * 3 * h * d + off, dtype=dtype)
        return [t.transpose(1, 2)
                for t in buf[off:].view(b, n, 3, h, d).unbind(2)]

    aligned, moved = fused(0), fused(offset)
    do = _offset_view((b, h, n, d), 0, dtype)
    do_moved = _offset_view((b, h, n, d), offset, dtype)
    before = dict(port_fa.KERNEL_LAUNCHES)
    for args in ((moved[0], *aligned[1:], do), (*aligned, do_moved)):
        assert port_fa._flash_bwd_variant(*args) == want
    assert port_fa.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype,d,offset,n,want", [
    (torch.bfloat16, 64, 0, 197, "tma"),         # ViT-B/16's layers
    (torch.bfloat16, 40, 0, 197, "tma"),         # d padded to 64 by TMA
    (torch.bfloat16, 64, 0, 1, "tma"),           # one token
    (torch.bfloat16, 64, 0, 300, "tma"),         # a 44-row last key tile
    (torch.bfloat16, 80, 0, 257, "wide_sync"),   # ViT-H's d 80
    (torch.bfloat16, 128, 0, 197, "wide_sync"),  # d past 64
    (torch.bfloat16, 64, 2, 197, "narrow"),      # 4 bytes off alignment
    (torch.bfloat16, 64, 8, 197, "tma"),         # 16 bytes in: aligned
    (torch.bfloat16, 42, 0, 197, "narrow"),      # d no multiple of 8
    (torch.float32, 64, 0, 197, "f32"),
])
def test_flash_forward_variant(dtype, d, offset, n, want):
    """The flash forward (K1) picks its kernel from the head width and the
    alignment of q, k and v alone, as ``csrc/flash_fwd.cu`` documents, and
    launches nothing to do so: each tensor a [B, H, N, d] view of a fused
    [B, N, 3, H, d] projection, one of them ``offset`` elements into its
    buffer."""
    b, h = 2, 3

    def fused(off):
        buf = torch.zeros(b * n * 3 * h * d + off, dtype=dtype)
        return [t.transpose(1, 2)
                for t in buf[off:].view(b, n, 3, h, d).unbind(2)]

    aligned, moved = fused(0), fused(offset)
    before = dict(port_fa.KERNEL_LAUNCHES)
    for i in range(3):
        args = list(aligned)
        args[i] = moved[i]
        assert port_fa._flash_fwd_variant(*args) == want
    assert port_fa.KERNEL_LAUNCHES == before
