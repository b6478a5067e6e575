"""The port's five SAM losses against the JAX package's on the same seeded
inputs, f32 on the CPU: every term's value and the gradient of the terms'
sum with respect to the mask logits and the IoU predictions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu_torch.core.registry import LOSSES

B, K, H, W = 4, 4, 24, 24

MASK_LOSSES = [
    ("SAMMultiLevelLoss", {}),
    ("SAMMultiLevelLoss", dict(alpha=0.6, gamma=1.5, focal_loss_weight=5.0,
                               dice_loss_weight=2.0,
                               iou_predict_loss_weight=0.5,
                               mask_threshold=0.3)),
    ("SAMMultiLevelIoUMaxLoss", {}),
    ("SAMMultiLevelIoUMaxLoss", dict(mask_threshold=-0.2, smooth=1e-3)),
    ("SAMMultiLevelAssignLoss", {}),
    ("SAMMultiLevelAssignLoss", dict(area_ranges=((0.3, 1.0), (0.0, 0.1),
                                                  (0.05, 0.4), (0.2, 0.6)))),
]


def _mask_inputs(seed):
    """Logits, IoU predictions and binary targets whose area ratios (2%,
    12%, 35%, 0%) hit different sets of the assignment loss's ranges, the
    empty target hitting none."""
    rng = np.random.RandomState(seed)
    masks = (2.0 * rng.randn(B, K, H, W)).astype(np.float32)
    ious = rng.rand(B, K).astype(np.float32)
    targets = np.zeros((B, H * W), np.float32)
    for i, ratio in enumerate((0.02, 0.12, 0.35, 0.0)):
        targets[i, rng.permutation(H * W)[:int(ratio * H * W)]] = 1.0
    return masks, ious, targets.reshape(B, H, W)


def _compare(port_terms, port_leaves, jax_fn, jax_args):
    """Values within 1e-5; gradients of the summed terms within 1e-6 (they
    are means over thousands of pixels, so small)."""
    (want_total, want_terms), want_grads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(jax_args))), has_aux=True)(*jax_args)
    assert set(port_terms) == set(want_terms)
    for key, val in port_terms.items():
        assert val.dim() == 0 and val.dtype == torch.float32
        assert val.item() == pytest.approx(float(want_terms[key]), abs=1e-5)
    total = sum(port_terms.values())
    assert total.item() == pytest.approx(float(want_total), abs=1e-5)
    grads = torch.autograd.grad(total, port_leaves)
    for g, w in zip(grads, want_grads):
        assert np.abs(np.asarray(w)).max() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-4)


@pytest.mark.parametrize("name,kwargs", MASK_LOSSES)
@pytest.mark.parametrize("target_shape", ["bhw", "b1hw"])
def test_mask_losses_match_jax(name, kwargs, target_shape):
    masks, ious, targets = _mask_inputs(seed=len(name) + len(kwargs))
    if target_shape == "b1hw":
        targets = targets[:, None]
    jax_loss = JAX_LOSSES.create(name, **kwargs)

    def jax_fn(m, i):
        terms = jax_loss((m, i), jnp.asarray(targets))
        return sum(terms.values()), terms

    leaves = [torch.from_numpy(a).requires_grad_() for a in (masks, ious)]
    terms = LOSSES.create(name, **kwargs)(tuple(leaves),
                                          torch.from_numpy(targets))
    _compare(terms, leaves, jax_fn, (jnp.asarray(masks), jnp.asarray(ious)))


def test_mask_losses_compute_in_f32_from_bf16_logits():
    masks, ious, targets = _mask_inputs(seed=9)
    loss = LOSSES.create("SAMMultiLevelLoss")
    want = loss((torch.from_numpy(masks).bfloat16().float(),
                 torch.from_numpy(ious)), torch.from_numpy(targets))
    got = loss((torch.from_numpy(masks).bfloat16(), torch.from_numpy(ious)),
               torch.from_numpy(targets))
    for key in want:
        assert got[key].dtype == torch.float32
        assert got[key].item() == want[key].item()


def test_assign_loss_rejects_a_wrong_level_count():
    with pytest.raises(ValueError, match="area ranges"):
        LOSSES.create("SAMMultiLevelAssignLoss", idx_nums=3)
    masks, ious, targets = map(torch.from_numpy, _mask_inputs(seed=1))
    with pytest.raises(ValueError, match="mask levels"):
        LOSSES.create("SAMMultiLevelAssignLoss")(
            (masks[:, :3], ious[:, :3]), targets)


def test_distill_mse_loss_matches_jax():
    rng = np.random.RandomState(2)
    stu, tea = (rng.randn(2, 8, 8, 16).astype(np.float32) for _ in range(2))
    want, want_grad = jax.value_and_grad(
        lambda s: JAX_LOSSES.create("SAMDistillMSELoss")(s, jnp.asarray(tea))
    )(jnp.asarray(stu))
    leaf = torch.from_numpy(stu).requires_grad_()
    got = LOSSES.create("SAMDistillMSELoss")(leaf, torch.from_numpy(tea))
    assert got.dim() == 0
    assert got.item() == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(torch.autograd.grad(got, leaf)[0].numpy(),
                               np.asarray(want_grad), atol=1e-7)


@pytest.mark.parametrize("kwargs", [{}, dict(
    alpha=0.5, gamma=1.0, distill_focal_loss_weight=3.0,
    distill_dice_loss_weight=0.5, distill_iou_predict_loss_weight=2.0,
    mask_threshold=0.4)])
def test_distill_loss_matches_jax(kwargs):
    rng = np.random.RandomState(3)
    tea_masks, stu_masks = ((2.0 * rng.randn(B, K, H, W)).astype(np.float32)
                            for _ in range(2))
    tea_ious, stu_ious = (rng.rand(B, K).astype(np.float32) for _ in range(2))
    jax_loss = JAX_LOSSES.create("SAMDistillLoss", **kwargs)

    def jax_fn(m, i):
        terms = jax_loss((jnp.asarray(tea_masks), jnp.asarray(tea_ious)),
                         (m, i))
        return sum(terms.values()), terms

    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (stu_masks, stu_ious)]
    terms = LOSSES.create("SAMDistillLoss", **kwargs)(
        (torch.from_numpy(tea_masks), torch.from_numpy(tea_ious)),
        tuple(leaves))
    _compare(terms, leaves, jax_fn,
             (jnp.asarray(stu_masks), jnp.asarray(stu_ious)))
