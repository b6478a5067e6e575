"""The port's semantic- and binary-segmentation losses against the JAX
package's, in f32 on the CPU: values and gradients of the ten losses (and
of their variants: CE without an ignore index, IoU and Dice on sigmoid
probabilities, the weighted combination), with ignored pixels, a class
absent for Lovasz, and probabilities clipped at both ends."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu_torch.core.registry import LOSSES

from _torch_port import one_torch_thread

IGNORE = 255
SEG_CASES = [
    ("SegCELoss", {"ignore_index": IGNORE}),
    ("SegCELoss", {}),
    ("SegMultiClassBCELoss", {"ignore_index": IGNORE}),
    ("SegIoULoss", {"ignore_index": IGNORE}),
    ("SegIoULoss", {"logit_type": "sigmoid", "ignore_index": IGNORE}),
    ("SegDiceLoss", {"ignore_index": IGNORE}),
    ("SegDiceLoss", {"logit_type": "sigmoid"}),
    ("SegLovaszLoss", {"ignore_index": IGNORE}),
    ("SegLovaszLoss", {}),
    ("SegCombinedLoss", {"loss_cfg": [
        ("SegCELoss", 1.0, {"ignore_index": IGNORE}),
        ("SegIoULoss", 0.5, {"logit_type": "softmax",
                             "ignore_index": IGNORE})]}),
]
BINARY_CASES = ["BinaryBCELoss", "OHEMBCELoss", "BCEIouloss", "BCEDiceLoss"]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _seg_inputs(seed=0, c=5):
    """Logits [2, 8, 12, c] with some beyond the clip (softmax and sigmoid
    probabilities under 1e-4 and over 1 - 1e-4), labels with ignored
    pixels, and class 3 absent."""
    rng = np.random.RandomState(seed)
    pred = (rng.randn(2, 8, 12, c) * 2).astype(np.float32)
    pred[0, 0, :4] = [12.0] + [-12.0] * (c - 1)
    label = rng.randint(0, c, (2, 8, 12)).astype(np.int32)
    label[label == 3] = 4
    label[1, :2] = IGNORE
    return pred, label


def _value_and_grad(jax_loss, port_loss, pred, label):
    want, want_grad = jax.value_and_grad(
        lambda x: jax_loss(x, jnp.asarray(label)))(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_()
    got = port_loss(x, torch.from_numpy(label))
    got.backward()
    return (got.item(), x.grad.numpy()), (float(want), np.asarray(want_grad))


@pytest.mark.parametrize("name,kwargs", SEG_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SEG_CASES)])
def test_segmentation_loss_matches_jax(name, kwargs):
    """Value within 1e-6 relative, gradient within 1e-8 absolute (its
    elements are about 1e-3: a mean over 192 pixels)."""
    pred, label = _seg_inputs()
    (got, got_grad), (want, want_grad) = _value_and_grad(
        JAX_LOSSES.create(name, **kwargs), LOSSES.create(name, **kwargs),
        pred, label)
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-8)
    assert np.abs(want_grad).max() > 0


def test_ce_loss_ignores_only_the_ignored_pixels():
    """Relabelling the ignored pixels changes nothing; without an ignore
    index they count, clamped to the last class as the JAX one-hot has
    it."""
    pred, label = _seg_inputs()
    loss = LOSSES.create("SegCELoss", ignore_index=IGNORE)
    other = label.copy()
    other[other == IGNORE] = 254
    a = loss(torch.from_numpy(pred), torch.from_numpy(label))
    b = LOSSES.create("SegCELoss", ignore_index=254)(
        torch.from_numpy(pred), torch.from_numpy(other))
    assert a.item() == b.item()
    clamped = label.copy()
    clamped[clamped == IGNORE] = pred.shape[-1] - 1
    c = LOSSES.create("SegCELoss")(torch.from_numpy(pred),
                                   torch.from_numpy(label))
    d = LOSSES.create("SegCELoss")(torch.from_numpy(pred),
                                   torch.from_numpy(clamped))
    assert c.item() == pytest.approx(d.item(), rel=1e-7)


@pytest.mark.parametrize("name", BINARY_CASES)
def test_binary_segmentation_loss_matches_jax(name):
    """Sigmoid probabilities [2, 8, 12, 1] (some beyond the clip) against a
    binary mask: value within 1e-6 relative, gradient within 1e-8."""
    rng = np.random.RandomState(1)
    pred = (1.0 / (1.0 + np.exp(-3 * rng.randn(2, 8, 12, 1)))).astype(
        np.float32)
    pred[0, 0, :3, 0] = [0.0, 1.0, 1e-6]
    label = (rng.rand(2, 8, 12) > 0.6).astype(np.float32)
    (got, got_grad), (want, want_grad) = _value_and_grad(
        JAX_LOSSES.create(name), LOSSES.create(name), pred, label)
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-8)


def test_ohem_keeps_the_hardest_negatives():
    """With 2 positives and ratio 1.5, three negatives count: the hardest."""
    p = torch.tensor([0.9, 0.8, 0.1, 0.7, 0.2, 0.6, 0.3])
    y = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    got = LOSSES.create("OHEMBCELoss")(p.reshape(1, 7, 1, 1),
                                       y.reshape(1, 7, 1))
    bce = -torch.log(torch.tensor([0.9, 0.8])).sum() - torch.log(
        1 - torch.tensor([0.7, 0.6, 0.3])).sum()
    assert got.item() == pytest.approx((bce / (5 + 1e-4)).item(), rel=1e-6)
