"""The port's CTC text recognition against the JAX package's, in f32 on the
CPU: the OCR ResNet trunks (basic and bottleneck blocks), ``BiLSTMEncoder``
against flax's cells through the LSTM weight rule both ways (outputs and
parameter gradients), ``TransformerEncoder``, ``CTCModel`` with either
encoder; ``CTCLoss`` against optax (repeated labels, a label longer than
the sequence allows, the focal weight; values and gradients) and
``ACELoss``; the converter, the collater, the character tables, the
string metrics and ``evaluate_text_recognition``.

Tolerances: eval outputs within 1e-5 of their largest value (the LSTM
encoder's within 1e-5 relative), weights moved both ways exactly, losses
within 1e-5 relative and their gradients within 1e-4 in relative L2; the
collater's images within 1e-5 (OpenCV's resize against ``F.interpolate``,
both /255); tables, texts, targets and metrics equal."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu.data import char_table as jax_tables
from simpleaicv_tpu.data import text_recognition as jax_data
from simpleaicv_tpu.models import text_recognition as jax_models
from simpleaicv_tpu.tasks import text_recognition as jax_task
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data import char_table as port_tables
from simpleaicv_tpu_torch.data import text_recognition as port_data
from simpleaicv_tpu_torch.models import text_recognition as port_models
from simpleaicv_tpu_torch.tasks import text_recognition as port_task

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _jax_variables(model, x, seed=1):
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), False))
    out = {"params": random_params(shapes["params"], seed)}
    if "batch_stats" in shapes:
        out["batch_stats"] = random_batch_stats(shapes["batch_stats"],
                                                seed + 1)
    return out


def _both_ways(model, variables):
    trees = [(variables["params"], export_jax_params(model))]
    if "batch_stats" in variables:
        trees.append((variables["batch_stats"],
                      export_jax_batch_stats(model)))
    for tree, back in trees:
        want, got = flatten_tree(tree), flatten_tree(back)
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.array_equal(got[path], w), path


# ---- the models ------------------------------------------------------------

@pytest.mark.parametrize("basic", [True, False])
def test_ocr_trunks_on_jax_weights(basic):
    """Each stage's eval output; a 32 x 64 crop ends 1 x 8."""
    x = np.random.RandomState(0).rand(2, 32, 64, 3).astype(np.float32)
    with jax_f32():
        model = jax_models.OCRResNetBackbone(basic=basic,
                                             layer_nums=(1, 1, 1, 1))
        variables = _jax_variables(model, x)
        want = jax.jit(lambda v, x: model.apply(v, x, False))(variables, x)
    port = port_models.OCRResNetBackbone(basic=basic, layer_nums=(1, 1, 1, 1),
                                         dtype=torch.float32)
    load_jax_params(port, variables["params"],
                    batch_stats=variables["batch_stats"])
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got[-1].shape == (2, 1, 8, 512 if basic else 2048)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    _both_ways(port, variables)


def test_bilstm_encoder_through_the_lstm_rule():
    """Outputs and every parameter's gradient against flax's
    ``OptimizedLSTMCell`` pair, the weights both ways, the reverse
    direction in order (``keep_order``)."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 16).astype(np.float32)
    r = rng.randn(3, 7, 16).astype(np.float32)
    model = jax_models.BiLSTMEncoder()
    variables = _jax_variables(model, x)

    def total(params):
        out = model.apply({"params": params}, x)
        return jnp.sum(out * r), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"])
    port = port_models.BiLSTMEncoder(16)
    load_jax_params(port, variables["params"])
    _both_ways(port, variables)
    assert not port.rnn1.bias_ih_l0.any()
    got = port(torch.from_numpy(x))
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= \
        1e-5 * np.abs(np.asarray(want)).max()
    (got * torch.from_numpy(r)).sum().backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in port.named_parameters()}
    assert port.rnn1.bias_ih_l0.grad is None  # fixed at zero, no update
    got_g = flatten_tree(export_jax_params(port, grads))
    want_g = flatten_tree(jax.tree.map(np.asarray, want_grads))
    assert set(got_g) == set(want_g)
    for path, w in want_g.items():
        assert _rel_l2(got_g[path], w) <= 1e-4, path


def test_seeded_lstm_init_draws_flax_distributions():
    lstm = port_models.BiLSTMEncoder(64).rnn1
    lstm.reset_parameters(torch.Generator().manual_seed(0))
    eye = torch.eye(64)
    for sfx in ("", "_reverse"):
        w_hh = getattr(lstm, f"weight_hh_l0{sfx}").detach()
        w_ih = getattr(lstm, f"weight_ih_l0{sfx}").detach()
        for g in range(4):
            block = w_hh[g * 64:(g + 1) * 64]
            assert torch.allclose(block @ block.T, eye, atol=1e-5)
        bound = 2.0 / 0.87962566103423978 / np.sqrt(64)
        assert w_ih.abs().max() <= bound + 1e-6
        assert 0.8 / 8 < float(w_ih.std()) < 1.2 / 8
        assert not getattr(lstm, f"bias_ih_l0{sfx}").any()
        assert not getattr(lstm, f"bias_hh_l0{sfx}").any()


def test_transformer_encoder_on_jax_weights():
    x = np.random.RandomState(3).randn(2, 9, 32).astype(np.float32)
    with jax_f32():
        model = jax_models.TransformerEncoder()
        variables = _jax_variables(model, x)
        want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, x))
    port = port_models.TransformerEncoder(32, dtype=torch.float32)
    load_jax_params(port, variables["params"])
    _both_ways(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("encoder", ["BiLSTMEncoder", "TransformerEncoder"])
def test_ctc_model_on_jax_weights(encoder):
    x = np.random.RandomState(4).rand(2, 32, 64, 3).astype(np.float32)
    kw = dict(backbone_type="resnet18", encoder_type=encoder,
              predictor_hidden_planes=32, num_classes=11)
    with jax_f32():
        model = jax_models.CTCModel(**kw)
        variables = _jax_variables(model, x)
        want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(
            variables, x))
    port = port_models.CTCModel(dtype=torch.float32, **kw)
    load_jax_params(port, variables["params"],
                    batch_stats=variables["batch_stats"])
    _both_ways(port, variables)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 11)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    factory = MODELS.create("CTCModelFactory", model_config={
        "backbone": {"name": "resnet18backbone"},
        "encoder": {"name": encoder},
        "predictor": {"param": {"hidden_planes": 32, "num_classes": 11}}})
    assert [n for n, _ in factory.named_parameters()] == \
        [n for n, _ in port.named_parameters()]


# ---- the losses ------------------------------------------------------------

def _ctc_case():
    """[4, 12, 6] logits; targets with repeats ([1, 1, 2] needs a blank
    between the 1s), a target of 10 with 5 repeats (needs 15 > 12 steps:
    no alignment), a short one."""
    rng = np.random.RandomState(5)
    preds = (rng.randn(4, 12, 6) * 2).astype(np.float32)
    targets = np.zeros((4, 10), np.int32)
    lengths = np.array([3, 10, 1, 4], np.int32)
    targets[0, :3] = [1, 1, 2]
    targets[1] = [3, 3, 4, 4, 5, 5, 1, 1, 2, 2]
    targets[2, :1] = [5]
    targets[3, :4] = [2, 3, 2, 1]
    return preds, targets, lengths


@pytest.mark.parametrize("name,kw", [("CTCLoss", {}),
                                     ("CTCLoss", {"use_focal_weight": True}),
                                     ("ACELoss", {})])
def test_recognition_losses_match_jax(name, kw):
    preds, targets, lengths = _ctc_case()
    jax_loss = JAX_LOSSES.create(name, **kw)
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, jnp.asarray(targets), jnp.asarray(lengths))))(
        jnp.asarray(preds))
    p = torch.tensor(preds, requires_grad=True)
    got = LOSSES.create(name, **kw)(p, torch.from_numpy(targets),
                                    torch.from_numpy(lengths))
    got.backward()
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert _rel_l2(p.grad.numpy(), np.asarray(want_grad)) <= 1e-4
    if name == "CTCLoss":
        # the sequence with no alignment adds nothing and takes no gradient
        assert not p.grad[1].any()


# ---- data, tables and metrics ----------------------------------------------

def test_char_tables_equal_the_jax_packages():
    assert port_tables.reference_char_table() == \
        jax_tables.reference_char_table()
    assert port_tables.final_char_table() == jax_tables.final_char_table()
    for chars in ("reference", "superset", list("0123456789")):
        want = jax_data.CTCTextLabelConverter(chars, str_max_length=6)
        got = port_data.CTCTextLabelConverter(chars, str_max_length=6)
        assert got.num_classes == want.num_classes
        texts = ["12x34", "0000000009", "", "9a8"]
        for g, w in zip(got.encode(texts), want.encode(texts)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        idx = np.random.RandomState(6).randint(0, 11, (5, 9))
        assert got.decode(idx) == want.decode(idx)


def test_collater_and_dataset_match_jax():
    conv = port_data.CTCTextLabelConverter(list("0123456789"), 10)
    jconv = jax_data.CTCTextLabelConverter(list("0123456789"), 10)
    jax_ds = jax_data.FakeTextRecognitionDataset(8)
    port_ds = port_data.FakeTextRecognitionDataset(8)
    want = jax_data.KeepRatioResizeTextRecognitionCollater(
        jconv, 32, 256)([jax_ds[i] for i in range(8)])
    got = port_data.KeepRatioResizeTextRecognitionCollater(
        conv, 32, 256)([port_ds[i] for i in range(8)])
    assert got["texts"] == want["texts"]
    for key in ("targets", "target_lengths"):
        assert np.array_equal(got[key], want[key])
    assert got["image"].shape == want["image"].shape == (8, 32, 256, 3)
    assert np.abs(got["image"] - want["image"]).max() <= 1e-5


def test_string_metrics_match_jax():
    rng = random.Random(7)
    for _ in range(200):
        a = "".join(rng.choice("abcAB ") for _ in range(rng.randint(0, 9)))
        b = "".join(rng.choice("abcAB ") for _ in range(rng.randint(0, 9)))
        assert port_task.lcs_length(a, b) == jax_task.lcs_length(a, b)
        assert port_task.edit_distance(a, b) == jax_task.edit_distance(a, b)
        assert port_task.normalized_edit_similarity(a, b) == \
            jax_task.normalized_edit_similarity(a, b)


def test_evaluation_matches_jax():
    """The greedy decode's metrics of a tiny CTC model on JAX weights, over
    two batches of the fake dataset."""
    conv = port_data.CTCTextLabelConverter(list("0123456789"), 10)
    ds = port_data.FakeTextRecognitionDataset(12)
    collate = port_data.KeepRatioResizeTextRecognitionCollater(conv, 32, 256)
    batches = [collate([ds[i] for i in range(k, k + 6)]) for k in (0, 6)]
    kw = dict(backbone_type="resnet18", encoder_type="BiLSTMEncoder",
              predictor_hidden_planes=32, num_classes=11)
    with jax_f32():
        model = jax_models.CTCModel(**kw)
        variables = _jax_variables(model, batches[0]["image"])
        # a bias toward the digits, so that the decode reads some
        variables["params"]["predictor"]["fc2"]["bias"][1:] += 3.0
        want = jax_task.evaluate_text_recognition(
            model, variables["params"],
            {"batch_stats": variables["batch_stats"]}, batches,
            jax_data.CTCTextLabelConverter(list("0123456789"), 10))
    port = port_models.CTCModel(dtype=torch.float32, **kw)
    load_jax_params(port, variables["params"],
                    batch_stats=variables["batch_stats"])
    got = port_task.evaluate_text_recognition(
        port, batches, conv,
        lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    assert got == pytest.approx(want, rel=1e-12)
    assert got["lcs_precision"] > 0
