"""The port's DBNet text detection against the JAX package's, in f32 on the
CPU: ``resnet18_dbnet`` (64-wide pyramid, 64^2 images) on seeded JAX
weights and BatchNorm statistics carried across by ``core.weights`` (eval
outputs, and the train-mode loss and gradients of every parameter),
``DBNetLoss`` and its gradients on drawn maps (the mining cutting the
negatives, no positive pixel, everything ignored), the map generator
(ignore flags, polygons under area 16, concave ones), the collater, the
decoder on exact and noisy maps and ``evaluate_text_detection``.

Tolerances: eval outputs within 1e-5 of their largest value; losses
within 1e-5 relative; loss gradients within 1e-4 in relative L2; the
model's train-mode parameter gradients within 2e-3 in relative L2 over
the whole tree (train-mode BatchNorm at batch 2 amplifies the two sides'
f32 rounding, as in the other ResNet tests); the generator's integer maps
equal and its threshold map within 1e-6; decoded polygons within 1e-3
pixels, scores within 1e-6 relative; the P/R/F1 equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.data import text_detection as jax_data
from simpleaicv_tpu.evaluation import text_eval as jax_eval
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data import text_detection as port_data
from simpleaicv_tpu_torch.evaluation import text_eval as port_eval

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

SIDE = 64
MAPS = ("probability_mask", "probability_ignore_mask", "threshold_mask",
        "threshold_ignore_mask")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """PyTorch's own convolution backward (``tests/test_torch_trainer.py``:
    oneDNN's f32 one parts from an f64 reference by several percent)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _batch(n=2, hw=SIDE, seed=0):
    ds = port_data.FakeTextDetectionDataset(n, image_hw=hw)
    return port_data.TextDetectionCollater(hw)([ds[seed + i]
                                                for i in range(n)])


# ---- the model -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dbnet():
    """(variables, batch, JAX eval output, JAX train loss terms, JAX
    parameter gradients), one jitted call each."""
    batch = _batch()
    image = batch["image"]
    maps = {k: jnp.asarray(batch[k]) for k in MAPS}
    with jax_f32():
        model = JAX_MODELS.create("resnet18_dbnet", inter_planes=64)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), False))
        variables = {"params": random_params(shapes["params"], 1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], 2)}
        out = jax.jit(lambda v, x: model.apply(v, x, False))(variables,
                                                              image)
        criterion = JAX_LOSSES.create("DBNetLoss")

        def total(params):
            preds, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(image), True, mutable=["batch_stats"])
            terms = criterion(preds, maps)
            return sum(terms.values()), terms

        (_, terms), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
            variables["params"])
    return (variables, batch, np.asarray(out),
            {k: float(v) for k, v in terms.items()},
            flatten_tree(jax.tree.map(np.asarray, grads)))


def _port_model(variables):
    model = MODELS.create("resnet18_dbnet", inter_planes=64,
                          dtype=torch.float32)
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


def test_forward_on_jax_weights(jax_dbnet):
    variables, batch, want = jax_dbnet[:3]
    model = _port_model(variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(batch["image"])).numpy()
    assert got.shape == want.shape == (2, SIDE, SIDE, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_weights_both_ways(jax_dbnet):
    variables = jax_dbnet[0]
    model = _port_model(variables)
    for tree, back in ((variables["params"], export_jax_params(model)),
                       (variables["batch_stats"],
                        export_jax_batch_stats(model))):
        want, got = flatten_tree(tree), flatten_tree(back)
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.array_equal(got[path], w), path


def test_train_loss_and_gradients_track_jax(jax_dbnet):
    variables, batch, _, want_terms, want_grads = jax_dbnet
    model = _port_model(variables).train()
    preds = model(torch.from_numpy(batch["image"]))
    terms = LOSSES.create("DBNetLoss")(
        preds, {k: torch.from_numpy(batch[k]) for k in MAPS})
    sum(terms.values()).backward()
    for key, w in want_terms.items():
        assert float(terms[key].detach()) == pytest.approx(w, rel=1e-4), key
    got = flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))
    assert set(got) == set(want_grads)
    keys = sorted(want_grads)
    g = np.concatenate([got[k].ravel() for k in keys])
    w = np.concatenate([want_grads[k].ravel() for k in keys])
    assert _rel_l2(g, w) <= 2e-3


def test_variants_without_backbones_name_what_is_missing():
    """The VAN and ConvFormer variants, which waited for their backbones,
    build on them (their trees: ``tests/test_torch_backbone_variants.py``)."""
    for name, bb in (("vanb2_dbnet", "VAN"),
                     ("convformerm36_dbnet", "MetaFormer")):
        assert name in JAX_MODELS
        with torch.device("meta"):
            assert type(MODELS.create(name).backbone).__name__ == bb


# ---- the loss --------------------------------------------------------------

def _loss_case(kind, rng):
    b, h, w = 2, 24, 20
    preds = np.stack([rng.rand(b, h, w), rng.rand(b, h, w)],
                     -1).astype(np.float32)
    p_mask = np.zeros((b, h, w), np.float32)
    p_mask[:, 5:9, 4:10] = 1.0          # 24 positives an image, 456 not
    p_ign = np.ones((b, h, w), np.float32)
    p_ign[:, 15:18, 2:6] = 0.0
    t_mask = (0.3 + 0.4 * rng.rand(b, h, w)).astype(np.float32)
    t_ign = np.zeros((b, h, w), np.float32)
    t_ign[:, 3:11, 2:12] = 1.0
    if kind == "no_positive":
        p_mask[:] = 0.0
    elif kind == "all_ignored":
        p_ign[:] = 0.0
        t_ign[:] = 0.0
    return preds, {"probability_mask": p_mask,
                   "probability_ignore_mask": p_ign,
                   "threshold_mask": t_mask, "threshold_ignore_mask": t_ign}


@pytest.mark.parametrize("kind", ["mining_cuts", "no_positive",
                                  "all_ignored"])
def test_loss_and_gradients_match_jax(kind):
    preds, shapes = _loss_case(kind, np.random.RandomState(3))

    def jax_total(p):
        terms = JAX_LOSSES.create("DBNetLoss")(p, {
            k: jnp.asarray(v) for k, v in shapes.items()})
        return sum(terms.values()), terms

    (_, want), want_grad = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))(jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    got = LOSSES.create("DBNetLoss")(p, {k: torch.from_numpy(v)
                                         for k, v in shapes.items()})
    sum(got.values()).backward()
    for key, w in want.items():
        assert float(got[key]) == pytest.approx(float(w), rel=1e-5,
                                                abs=1e-7), key
    if kind == "mining_cuts":
        assert all(float(v) > 0 for v in got.values())
    else:
        assert float(got["probability_map_loss"]) == 0.0
        assert float(got["binary_map_loss"]) == 0.0
    want_grad = np.asarray(want_grad)
    if np.abs(want_grad).max() == 0:
        assert not p.grad.numpy().any()
    else:
        assert _rel_l2(p.grad.numpy(), want_grad) <= 1e-4


# ---- data ------------------------------------------------------------------

def _generator_samples():
    """Fake samples, and samples whose polygons are ignored, under area 16
    or concave."""
    samples = []
    for hw in (64, 128):
        ds = jax_data.FakeTextDetectionDataset(image_hw=hw)
        for i in range(6):
            s = ds[i]
            samples.append({"image": s["image"], "annots": s["annots"],
                            "ignore_flags": s["ignore_flags"]})
    image = np.zeros((90, 100, 3), np.float32)
    samples.append({"image": image, "annots": [
        np.array([[10, 10], [60, 12], [58, 30], [12, 28]], np.float32),
        np.array([[70, 60], [73, 60], [73, 63], [70, 63]], np.float32),
        np.array([[5, 40], [50, 40], [50, 80], [35, 80], [35, 55],
                  [5, 55]], np.float32),
        np.array([[60, 35], [95, 35], [95, 50], [60, 50]], np.float32)],
        "ignore_flags": [False, False, False, True]})
    return samples


def test_map_generator_matches_jax():
    for s in _generator_samples():
        want = jax_data.DBNetMapGenerator()(dict(s))
        got = port_data.DBNetMapGenerator()(dict(s))
        for key in ("probability_mask", "probability_ignore_mask",
                    "threshold_ignore_mask"):
            assert got[key].dtype == np.float32
            assert np.array_equal(got[key], want[key]), key
        assert np.abs(got["threshold_mask"]
                      - want["threshold_mask"]).max() <= 1e-6
    last = port_data.DBNetMapGenerator()(dict(_generator_samples()[-1]))
    assert (last["probability_ignore_mask"] == 0).any()


def test_fake_dataset_and_collater_match_jax():
    jax_ds = jax_data.FakeTextDetectionDataset(4, image_hw=96)
    port_ds = port_data.FakeTextDetectionDataset(4, image_hw=96)
    want = jax_data.TextDetectionCollater(128)([jax_ds[i] for i in range(4)])
    got = port_data.TextDetectionCollater(128)([port_ds[i]
                                                for i in range(4)])
    assert set(got) == set(want)
    assert np.array_equal(got["image"], want["image"])
    for key in MAPS:
        assert np.abs(got[key] - want[key]).max() <= 1e-6, key
    for gp, wp in zip(got["polys"], want["polys"]):
        assert all(np.array_equal(a, b) for a, b in zip(gp, wp))


def _decoder_maps():
    """[B, H, W, 2] maps: the fake samples' probability masks exactly, the
    same with noise, and an L-shaped region (curved text)."""
    rng = np.random.RandomState(4)
    ds = jax_data.FakeTextDetectionDataset(image_hw=128)
    exact = np.stack([ds[i]["probability_mask"] for i in range(4)])
    noisy = np.clip(exact * 0.9 + 0.35 * rng.rand(*exact.shape), 0, 1)
    ell = np.zeros((1, 128, 128), np.float32)
    ell[0, 20:40, 10:100] = 0.9
    ell[0, 40:110, 80:100] = 0.9
    probs = np.concatenate([exact, noisy, ell]).astype(np.float32)
    return np.stack([probs, np.full_like(probs, 0.5)], -1), ds


def test_decoder_and_polygon_eval_match_jax():
    maps, ds = _decoder_maps()
    want = jax_data.DBNetDecoder()(maps)
    got = port_data.DBNetDecoder()(torch.from_numpy(maps))
    assert len(got) == len(want)
    n_boxes = 0
    for (gb, gs), (wb, ws) in zip(got, want):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            assert g.dtype == np.float32 and g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-3
        np.testing.assert_allclose(gs, ws, rtol=1e-6)
        n_boxes += len(gb)
    assert n_boxes >= 8 and any(len(b) > 4 for b in got[-1][0])
    gts = [ds[i]["annots"] for i in range(4)] * 2 + [[np.array(
        [[10, 20], [100, 20], [100, 110], [10, 110]], np.float32)]]
    results = [{"pred_polys": list(b), "gt_polys": list(g),
                "gt_ignore": [False] * (len(g) - 1) + [len(g) > 2]}
               for (b, _), g in zip(got, gts)]
    want_stats = jax_eval.evaluate_text_detection(results)
    got_stats = port_eval.evaluate_text_detection(results)
    assert got_stats == want_stats
    assert 0 < got_stats["f1"] <= 100
