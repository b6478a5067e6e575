"""The port's auction matcher (``ops/matcher.py``) against the JAX
package's, and both DETR losses with ``matcher="auction"`` against the JAX
losses, in f32 on the CPU. The assignments must be equal: the port keeps
the JAX function's ties (the first maximum, ``eps`` from the f32 span,
dropped out-of-range scatters), and runs its loop in chunks between host
checks, which changes nothing once no bidder is left and never runs past
``max_iters``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from simpleaicv_tpu.losses.detr import DETRLoss as JaxDETRLoss
from simpleaicv_tpu.losses.dinodetr import DINODETRLoss as JaxDINOLoss
from simpleaicv_tpu.ops.matcher import auction_match_batch as jax_auction
from simpleaicv_tpu_torch.core.registry import LOSSES
from simpleaicv_tpu_torch.ops import matcher
from simpleaicv_tpu_torch.ops.matcher import auction_match_batch

from _torch_port import one_torch_thread

_jax_match = jax.jit(jax_auction, static_argnames=("max_iters", "eps"))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _case(kind, seed, b=3, q=40, m=9):
    """(cost [B, Q, M] with 1e8 at invalid slots, valid [B, M], max_iters)
    of one kind of case."""
    rng = np.random.RandomState(seed)
    cost = rng.rand(b, q, m).astype(np.float32) * 10
    valid = rng.rand(b, m) > 0.25
    max_iters = 2000
    if kind == "near_duplicates":
        # every gt nearly the same column: contention that hits the cap
        cost[:] = cost[:, :, :1] + rng.rand(b, q, m).astype(np.float32) * 1e-3
        max_iters = 40
    elif kind == "all_invalid":
        valid[1] = False
    elif kind == "non_finite":
        cost[0, 3, 2] = np.inf
        cost[2, 5, 1] = np.nan
    cost = np.where(valid[:, None, :], cost, 1e8).astype(np.float32)
    return cost, valid, max_iters


@pytest.mark.parametrize("kind", ["random", "near_duplicates", "all_invalid",
                                  "non_finite"])
@pytest.mark.parametrize("seed", [0, 1])
def test_assignments_equal_jax(kind, seed):
    cost, valid, max_iters = _case(kind, seed)
    want = np.asarray(_jax_match(jnp.asarray(cost), jnp.asarray(valid),
                                 max_iters=max_iters))
    got = auction_match_batch(torch.from_numpy(cost),
                              torch.from_numpy(valid), max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "all_invalid":
        assert (got[1] == -1).all()
    if kind == "near_duplicates":
        # the cap left some gts unmatched, in both packages alike
        assert (got >= 0).sum() < valid.sum()


def test_within_the_auction_bound_of_the_optimum():
    """Every valid gt matched once, and the total cost within n_gt * eps of
    scipy's optimum (eps = 1e-4 of the span, at least 1e-3)."""
    cost, valid, _ = _case("random", 3, b=4, q=60, m=12)
    got = auction_match_batch(torch.from_numpy(cost),
                              torch.from_numpy(valid)).numpy()
    for i in range(cost.shape[0]):
        cols = np.nonzero(valid[i])[0]
        rows, sub = linear_sum_assignment(cost[i][:, cols])
        best = cost[i][rows, cols[sub]].sum()
        matched = np.nonzero(got[i] >= 0)[0]
        assert sorted(got[i][matched]) == list(cols)
        total = cost[i][matched, got[i][matched]].sum()
        eps = max(np.abs(cost[i][:, cols]).max() * 1e-4, 1e-3)
        assert total <= best + len(cols) * eps + 1e-4


def test_chunks_stop_at_max_iters(monkeypatch):
    """A cap that is not a multiple of the chunk gives the JAX result."""
    cost, valid, _ = _case("near_duplicates", 4)
    monkeypatch.setattr(matcher, "CHUNK", 7)
    want = np.asarray(_jax_match(jnp.asarray(cost), jnp.asarray(valid),
                                 max_iters=30))
    got = auction_match_batch(torch.from_numpy(cost),
                              torch.from_numpy(valid), max_iters=30)
    np.testing.assert_array_equal(got.numpy(), want)


def _detr_inputs(seed, layers=2, b=2, q=16, m=5, c=6, sigmoid=False):
    rng = np.random.RandomState(seed)
    logits = rng.randn(layers, b, q, c + (0 if sigmoid else 1))
    boxes = 1 / (1 + np.exp(-rng.randn(layers, b, q, 4)))
    ann = np.full((b, m, 5), -1.0, np.float32)
    ann[0, :4, :4] = (1 / (1 + np.exp(-rng.randn(4, 4)))) * [1, 1, .5, .5]
    ann[0, :4, 4] = [1, 3, 1, 5]
    ann[1, :2, :4] = (1 / (1 + np.exp(-rng.randn(2, 4)))) * [1, 1, .5, .5]
    ann[1, :2, 4] = [0, 2]
    return (logits.astype(np.float32), boxes.astype(np.float32), ann)


def test_detr_loss_with_auction_matches_jax():
    logits, boxes, ann = _detr_inputs(0)
    want = JaxDETRLoss(num_classes=6, matcher="auction")(
        (jnp.asarray(logits), jnp.asarray(boxes)), jnp.asarray(ann))
    port = LOSSES.create("DETRLoss", num_classes=6, matcher="auction")
    got = port((torch.from_numpy(logits), torch.from_numpy(boxes)),
               torch.from_numpy(ann))
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].item() == pytest.approx(float(val), rel=1e-5,
                                                abs=1e-6), key


def test_dinodetr_loss_with_auction_matches_jax():
    logits, boxes, ann = _detr_inputs(1, layers=3, sigmoid=True)
    rng = np.random.RandomState(2)
    preds = {"aux_pred_logits": logits, "aux_pred_boxes": boxes,
             "pred_logits": logits[-1], "pred_boxes": boxes[-1],
             "interm_pred_logits": rng.randn(*logits.shape[1:]).astype(
                 np.float32),
             "interm_pred_boxes": (1 / (1 + np.exp(-rng.randn(
                 *boxes.shape[1:])))).astype(np.float32)}
    want = JaxDINOLoss(num_classes=6, matcher="auction")(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(ann))
    port = LOSSES.create("DINODETRLoss", num_classes=6, matcher="auction")
    got = port({k: torch.from_numpy(v) for k, v in preds.items()},
               torch.from_numpy(ann))
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].item() == pytest.approx(float(val), rel=1e-5,
                                                abs=1e-6), key
    # the auction's matches of every layer are the JAX ones
    jax_loss = JaxDINOLoss(num_classes=6, matcher="auction")
    for layer in range(logits.shape[0]):
        np.testing.assert_array_equal(
            port.match(torch.from_numpy(logits[layer]),
                       torch.from_numpy(boxes[layer]),
                       torch.from_numpy(ann)).numpy(),
            np.asarray(jax_loss._match(jnp.asarray(logits[layer]),
                                       jnp.asarray(boxes[layer]),
                                       jnp.asarray(ann))))


def test_an_unknown_matcher_is_refused():
    with pytest.raises(ValueError, match="matcher"):
        LOSSES.create("DETRLoss", matcher="greedy")
    with pytest.raises(ValueError, match="matcher"):
        LOSSES.create("DINODETRLoss", matcher="greedy")
