"""The port's DETR against the JAX package's, in f32 on the CPU, on a tiny
resnet18_detr (64^2 with a padded image, 1 encoder and 2 decoder layers,
hidden 64, 20 queries) with seeded weights and BatchNorm statistics: the
eval forward with a padding mask, the train forward (dropout off) with its
updated statistics, ``DETRLoss`` on the same predictions and the slice's
loss function through ``make_detr_loss_fn``, all within 1e-5 relative to
the largest value; and the weights both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.losses.detr import DETRLoss as JaxDETRLoss
from simpleaicv_tpu.tasks import detection as jax_task
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.tasks.detection import make_detr_loss_fn

from _torch_port import (flatten_tree, jax_f32, random_batch_stats,
                         random_params)

IMG = 64
TINY_DETR = dict(num_classes=8, query_nums=20, encoder_layer_nums=1,
                 decoder_layer_nums=2, hidden_inplanes=64, dropout_prob=0.0)


def _batch():
    rng = np.random.RandomState(0)
    image = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    mask = np.zeros((2, IMG, IMG), np.float32)
    mask[1, :, 40:] = 1.0  # the second image is 64 x 40
    ann = np.full((2, 4, 5), -1.0, np.float32)
    ann[0, 0] = [0.5, 0.5, 0.2, 0.2, 3]
    ann[1, 0] = [0.3, 0.3, 0.1, 0.2, 1]
    ann[1, 1] = [0.7, 0.6, 0.2, 0.1, 5]
    return image, mask, ann


def _rel_close(got, want, what, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        what, np.abs(got - want).max() / scale)


@pytest.fixture(scope="module")
def detr():
    image, mask, ann = _batch()
    with jax_f32():
        model = JAX_MODELS.create("resnet18_detr", **TINY_DETR)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0)}, jnp.asarray(image),
            jnp.asarray(mask), False))
        variables = {"params": random_params(shapes["params"], seed=1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], seed=2)}
        eval_out = jax.jit(lambda v, x, m: model.apply(v, x, m, False))(
            variables, jnp.asarray(image), jnp.asarray(mask))
        train_out, new_vars = jax.jit(lambda v, x, m: model.apply(
            v, x, m, True, mutable=["batch_stats"]))(
            variables, jnp.asarray(image), jnp.asarray(mask))
        loss_fn = jax_task.make_detr_loss_fn(model, JaxDETRLoss(num_classes=8))
        batch = {"image": jnp.asarray(image), "mask": jnp.asarray(mask),
                 "scaled_annots": jnp.asarray(ann)}
        loss, (terms, _) = jax.jit(lambda p, s: loss_fn(
            p, s, batch, jax.random.PRNGKey(0), True))(
            variables["params"], {"batch_stats": variables["batch_stats"]})
    return dict(variables=variables, image=image, mask=mask, ann=ann,
                eval=[np.asarray(o) for o in eval_out],
                train=[np.asarray(o) for o in train_out],
                train_stats=jax.tree.map(np.asarray,
                                         new_vars["batch_stats"]),
                loss=float(loss),
                terms={k: float(v) for k, v in terms.items()})


def _port_model(variables):
    model = MODELS.create("resnet18_detr", **TINY_DETR, dtype=torch.float32)
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


def test_eval_forward_with_a_padding_mask_matches_jax(detr):
    model = _port_model(detr["variables"]).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(detr["image"]),
                    torch.from_numpy(detr["mask"]), False)
    assert out[0].shape == (2, 2, 20, 9) and out[1].shape == (2, 2, 20, 4)
    for name, got, want in zip(("cls", "boxes"), out, detr["eval"]):
        _rel_close(got.numpy(), want, name)


def test_train_forward_matches_jax(detr):
    """Batch statistics in the backbone: the outputs and the updated
    running statistics."""
    model = _port_model(detr["variables"]).train()
    out = model(torch.from_numpy(detr["image"]),
                torch.from_numpy(detr["mask"]), True)
    for name, got, want in zip(("cls", "boxes"), out, detr["train"]):
        _rel_close(got.detach().numpy(), want, name)
    got = flatten_tree(export_jax_batch_stats(model))
    want = flatten_tree(detr["train_stats"])
    assert set(got) == set(want)
    for path in want:
        _rel_close(got[path], want[path], path)


def test_detr_loss_matches_jax():
    """The same predictions and annotations, three layers: every term
    within 1e-5 relative, and the same matching."""
    rng = np.random.RandomState(3)
    cls = rng.randn(3, 2, 20, 9).astype(np.float32)
    reg = rng.uniform(0.05, 0.95, (3, 2, 20, 4)).astype(np.float32)
    _, _, ann = _batch()
    jax_loss = JaxDETRLoss(num_classes=8)
    want = jax_loss([jnp.asarray(cls), jnp.asarray(reg)], jnp.asarray(ann))
    loss = LOSSES.create("DETRLoss", num_classes=8)
    got = loss([torch.from_numpy(cls), torch.from_numpy(reg)],
               torch.from_numpy(ann))
    assert set(got) == set(want) and len(got) == 9
    for key in want:
        _rel_close(got[key].numpy(), np.asarray(want[key]), key)
    np.testing.assert_array_equal(
        loss.match(torch.from_numpy(cls[-1]), torch.from_numpy(reg[-1]),
                   torch.from_numpy(ann)).numpy(),
        np.asarray(jax_loss._match(jnp.asarray(cls[-1]),
                                   jnp.asarray(np.clip(reg[-1], 1e-4,
                                                       1 - 1e-4)),
                                   jnp.asarray(ann))))


def test_detr_loss_fn_matches_jax(detr):
    """The slice's loss function: the DETR model sees the padding mask,
    the criterion the normalised annotations."""
    model = _port_model(detr["variables"])
    batch = {"image": torch.from_numpy(detr["image"]),
             "mask": torch.from_numpy(detr["mask"]),
             "scaled_annots": torch.from_numpy(detr["ann"])}
    loss, terms = make_detr_loss_fn(LOSSES.create(
        "DETRLoss", num_classes=8))(model, batch, None, True)
    assert set(terms) == set(detr["terms"])
    for key, want in detr["terms"].items():
        assert terms[key].item() == pytest.approx(want, rel=1e-5), key
    assert loss.item() == pytest.approx(detr["loss"], rel=1e-5)


def test_weights_both_ways(detr):
    model = _port_model(detr["variables"])
    got = flatten_tree(export_jax_params(model))
    want = flatten_tree(detr["variables"]["params"])
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert "reg_head_1/kernel" in want and "query_embed" in want
