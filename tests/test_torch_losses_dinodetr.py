"""The port's DINO-DETR loss against the JAX package's, in f32 on the CPU:
every term on the same predictions (decoder layers, encoder proposals and
denoising slots), the Hungarian matches of every layer, the gradients with
respect to the predictions, the GIoU it is built on, and the box helpers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.losses.detr import _cxcywh_to_xyxy, _pairwise_giou
from simpleaicv_tpu.losses.dinodetr import DINODETRLoss as JaxLoss
from simpleaicv_tpu.ops.iou import iou_method as jax_iou
from simpleaicv_tpu_torch.core.registry import LOSSES
from simpleaicv_tpu_torch.losses.detr import (cxcywh_to_xyxy,
                                              hungarian_match, pairwise_giou)
from simpleaicv_tpu_torch.ops.iou import iou_method

L, B, Q, C, M, PAD = 3, 2, 12, 8, 5, 8


def _preds_and_annotations(seed, empty_image):
    """Predictions of 3 layers, the encoder proposals and 8 denoising slots
    (two groups of 2 positives and 2 negatives of 2 annotations; image 1
    has one annotation, so its slots of annotation 1 are padding)."""
    rng = np.random.RandomState(seed)

    def boxes(*shape):
        return (1 / (1 + np.exp(-rng.randn(*shape, 4)))).astype(np.float32)

    preds = {"aux_pred_logits": rng.randn(L, B, Q, C).astype(np.float32),
             "aux_pred_boxes": boxes(L, B, Q),
             "interm_pred_logits": rng.randn(B, Q, C).astype(np.float32),
             "interm_pred_boxes": boxes(B, Q),
             "dn_pred_logits": rng.randn(L, B, PAD, C).astype(np.float32),
             "dn_pred_boxes": boxes(L, B, PAD)}
    preds["pred_logits"] = preds["aux_pred_logits"][-1]
    preds["pred_boxes"] = preds["aux_pred_boxes"][-1]
    ann = np.full((B, M, 5), -1.0, np.float32)
    ann[0, :3, :4] = boxes(3) * [1, 1, 0.5, 0.5]
    ann[0, :3, 4] = [2, 5, 2]
    if not empty_image:
        ann[1, 0] = [0.4, 0.6, 0.3, 0.2, 7]
    slot = np.arange(PAD)
    gt_index = np.broadcast_to(slot % 4 % 2, (B, PAD)).astype(np.int64)
    positive = np.broadcast_to(slot % 4 < 2, (B, PAD))
    num_valid = (ann[..., 4] >= 0).sum(1)
    meta = {"pad_size": PAD, "dn_gt_index": gt_index,
            "dn_valid": gt_index < num_valid[:, None],
            "dn_is_positive": positive.copy()}
    return preds, meta, ann


def _to_jax(preds, meta):
    out = {k: jnp.asarray(v) for k, v in preds.items()}
    out["dn_meta"] = {k: v if k == "pad_size" else jnp.asarray(v)
                      for k, v in meta.items()}
    return out


def _to_torch(preds, meta):
    out = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    out["dn_meta"] = {k: v if k == "pad_size" else torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in meta.items()}
    return out


@pytest.mark.parametrize("empty_image", [False, True])
def test_every_term_and_gradient_matches_jax(empty_image):
    preds, meta, ann = _preds_and_annotations(0, empty_image)
    jax_loss = JaxLoss(num_classes=C)

    def total(p):
        terms = jax_loss({**p, "dn_meta": _to_jax(preds, meta)["dn_meta"]},
                         jnp.asarray(ann))
        return sum(terms.values()), terms

    (want_total, want), want_grads = jax.jit(jax.value_and_grad(
        total, has_aux=True))({k: jnp.asarray(v) for k, v in preds.items()})
    port = LOSSES.create("DINODETRLoss", num_classes=C)
    tpreds = _to_torch(preds, meta)
    got = port(tpreds, torch.from_numpy(ann))
    assert set(got) == set(want) and len(got) == 3 * (L + 1 + L)
    for key, val in want.items():
        assert got[key].item() == pytest.approx(float(val), rel=1e-5,
                                                abs=1e-6), key
    sum(got.values()).backward()
    assert sum(got.values()).item() == pytest.approx(float(want_total),
                                                     rel=1e-5)
    for key in ("aux_pred_logits", "aux_pred_boxes", "interm_pred_logits",
                "interm_pred_boxes", "dn_pred_logits", "dn_pred_boxes"):
        w = np.asarray(want_grads[key])
        err = np.abs(tpreds[key].grad.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1.0), key


def test_matches_agree_with_jax():
    preds, _, ann = _preds_and_annotations(1, empty_image=False)
    jax_loss, port = JaxLoss(num_classes=C), LOSSES.create(
        "DINODETRLoss", num_classes=C)
    for layer in range(L):
        cls, reg = preds["aux_pred_logits"][layer], \
            preds["aux_pred_boxes"][layer]
        want = np.asarray(jax_loss._match(jnp.asarray(cls), jnp.asarray(reg),
                                          jnp.asarray(ann)))
        got = port.match(torch.from_numpy(cls), torch.from_numpy(reg),
                         torch.from_numpy(ann))
        np.testing.assert_array_equal(got.numpy(), want)
        # every valid annotation is matched once, nothing else
        valid = ann[..., 4] >= 0
        for i in range(B):
            matched = got[i][got[i] >= 0].numpy()
            assert sorted(matched) == list(np.nonzero(valid[i])[0])


def test_hungarian_match_handles_non_finite_costs():
    """+inf counts as 1e8 and NaN as 0, as in the JAX package's matcher:
    the cheapest assignment is then query 0 -> box 0, query 1 -> box 1."""
    cost = torch.tensor([[[1.0, float("inf")], [float("nan"), 0.5],
                          [2.0, 3.0]]])
    got = hungarian_match(cost, torch.tensor([[True, True]]))
    assert got.tolist() == [[0, 1, -1]] and got.dtype == torch.int64
    none = hungarian_match(cost, torch.tensor([[False, False]]))
    assert none.tolist() == [[-1, -1, -1]]


@pytest.mark.parametrize("iou_type", ["IoU", "GIoU"])
def test_iou_matches_jax(iou_type):
    """Overlapping, disjoint and degenerate (zero-width) pairs."""
    rng = np.random.RandomState(2)
    xy = rng.rand(2, 7, 2).astype(np.float32)
    wh = rng.rand(2, 7, 2).astype(np.float32) * 0.5
    wh[0, 0, 0] = 0.0
    a = np.concatenate([xy, xy + wh], -1)
    b = np.roll(a, 3, axis=1) * 0.9
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), iou_type))
    got = iou_method(torch.from_numpy(a), torch.from_numpy(b), iou_type)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError, match="unknown iou_type"):
        iou_method(torch.from_numpy(a), torch.from_numpy(b), "XIoU")


def test_box_helpers_match_jax():
    rng = np.random.RandomState(3)
    a = rng.rand(6, 4).astype(np.float32)
    b = rng.rand(4, 4).astype(np.float32)
    np.testing.assert_allclose(
        cxcywh_to_xyxy(torch.from_numpy(a)).numpy(),
        np.asarray(_cxcywh_to_xyxy(jnp.asarray(a))), atol=1e-7)
    xa, xb = (np.array(_cxcywh_to_xyxy(jnp.asarray(x))) for x in (a, b))
    want = np.asarray(_pairwise_giou(jnp.asarray(xa), jnp.asarray(xb)))
    got = pairwise_giou(torch.from_numpy(xa), torch.from_numpy(xb))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
