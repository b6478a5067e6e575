"""The port's SAM matting (``simpleaicv_tpu_torch/models/
interactive_segmentation/sam_matting.py``, ``losses/sam_matting.py``,
``data/interactive_segmentation.py::SAMMattingCollater``,
``tools/{train,test}_interactive_matting.py``) against the JAX package's on
the CPU, in f32:

* ``FusionHead`` and ``collaborative_matting`` (ties go to the first
  maximum) on seeded inputs;
* sam_b_matting1 with ``SAMMattingOneLevelLoss`` and sam_b_matting2 with
  ``SAMMattingMultiLevelAssignLoss``, the tiny SAM at 256^2 (its global
  layer's 256 tokens take the flash path): the four outputs to 1e-4 of
  their scale, the loss terms to 1e-4 relative, every parameter's gradient
  within 1% of JAX's in L2 at a cosine above 0.9999;
* the four loss stacks and their gradients on seeded predictions, with
  samples whose area ratios fall inside, outside and on the edges of the
  Assign stack's windows;
* ``SAMMattingCollater`` bit for bit under shared seeds;
* two engine steps of sam_b_matting1 (AdamW, CosineLR) against the JAX
  steps, as ``tests/test_torch_sam_task.py`` holds SAM's;
* the train and test CLIs on ``fake_synthetic/tiny_sam_matting``.
"""

import importlib.util
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.data import interactive_segmentation as jax_data
from simpleaicv_tpu.models.interactive_segmentation import \
    sam_matting as jax_sam_matting
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.data import interactive_segmentation as port_data
from simpleaicv_tpu_torch.data.matting import (FakeHumanMattingDataset,
                                               MattingNormalize)
from simpleaicv_tpu_torch.models.interactive_segmentation import \
    sam_matting as port_sam_matting
from simpleaicv_tpu_torch.tools import (test_interactive_matting,
                                        train_interactive_matting)

from _torch_port import (TINY_SAM, flatten_tree, jax_f32, one_torch_thread,
                         random_params)

REPO = Path(__file__).resolve().parent.parent
RECIPE = (REPO / "experiments/13.interactive_segmentation_training/"
          "fake_synthetic/tiny_sam_matting")
IMG = 256
# kind -> (multi_level, its loss); the registered sam_b_matting{1,2} fix
# SAM-B's widths, so the tiny models are built as the tiny_sam_matting
# config builds its own
KINDS = {"matting1": (False, "SAMMattingOneLevelLoss"),
         "matting2": (True, "SAMMattingMultiLevelAssignLoss")}
STACKS = ("SAMMattingOneLevelLoss", "SAMMattingMultiLevelLoss",
          "SAMMattingMultiLevelIoUMaxLoss", "SAMMattingMultiLevelAssignLoss")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/train_interactive_matting.py as a module (it
    imports its sibling ``common``)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_train_interactive_matting",
            REPO / "tools" / "train_interactive_matting.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "tools"))
        sys.modules.pop("common", None)
    return module


def _to_jax(batch):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in batch.items()}


def _to_torch(batch):
    return {k: None if v is None else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


# ---- the head and the fusion ----

def test_fusion_head_matches_jax():
    rng = np.random.RandomState(0)
    masks = rng.randn(2, 16, 16, 4).astype(np.float32)
    feat3 = rng.randn(2, 4, 4, 64).astype(np.float32)
    feat1 = rng.randn(2, 16, 16, 8).astype(np.float32)
    head = jax_sam_matting.FusionHead()
    with jax_f32():
        shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0), masks,
                                feat3, feat1)
        params = random_params(shapes["params"], seed=1)

        def fn(p):
            g, l = head.apply({"params": p}, masks, feat3, feat1)
            return jnp.sum(g * g) + jnp.sum(l), (g, l)

        (_, (wg, wl)), wgrad = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
    port = port_sam_matting.FusionHead(4, 64, 8, dtype=torch.float32)
    load_jax_params(port, params, root="fusion_pred")
    g, l = port(*map(torch.from_numpy, (masks, feat3, feat1)))
    assert g.shape == (2, 64, 64, 3) and l.shape == (2, 64, 64, 1)
    for got, want in ((g, wg), (l, wl)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    ((g * g).sum() + l.sum()).backward()
    got = flatten_tree(export_jax_params(
        port, {n: p.grad for n, p in port.named_parameters()},
        root="fusion_pred"))
    for path, w in flatten_tree(jax.tree.map(np.asarray, wgrad)).items():
        np.testing.assert_allclose(got[path], w,
                                   atol=1e-4 * np.abs(w).max(), err_msg=path)


def test_collaborative_matting_takes_the_first_maximum():
    g = np.array([[0.2, 0.5, 0.3], [0.4, 0.4, 0.2], [0.1, 0.45, 0.45],
                  [0.3, 0.3, 0.3], [0.1, 0.2, 0.7]], np.float32)[None]
    loc = np.array([[0.6], [0.7], [0.8], [0.9], [0.25]], np.float32)[None]
    want = jax_sam_matting.collaborative_matting(jnp.asarray(g),
                                                 jnp.asarray(loc))
    got = port_sam_matting.collaborative_matting(torch.from_numpy(g),
                                                 torch.from_numpy(loc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, :, 0].tolist() == pytest.approx([0.6, 0.0, 0.8, 0.0,
                                                   1.0])


# ---- the whole models at 256^2 ----

def _batch(n=1, hw=IMG, seed=0):
    """``n`` synthetic portraits through the port's collater, its
    generators seeded by ``seed``."""
    ds = FakeHumanMattingDataset(n, hw, transform=MattingNormalize())
    collate = port_data.SAMMattingCollater(
        resize=hw, max_points=4, positive_point_num_range=(1, 3),
        rng=random.Random(seed), np_rng=np.random.RandomState(seed))
    return collate([ds[i] for i in range(n)])


def _prompts(batch):
    return {"prompt_point": batch["prompt_point"],
            "prompt_box": batch["prompt_box"], "prompt_mask": None}


@pytest.fixture(scope="module")
def models():
    """{kind: (JAX model, seeded params)} at 256^2."""
    batch = _to_jax(_batch(2))
    out = {}
    for kind, (multi_level, _) in KINDS.items():
        jm = jax_sam_matting.SAMMatting(
            sam=JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM),
            multi_level=multi_level)
        with jax_f32():
            shapes = jax.eval_shape(lambda m=jm: m.init(
                jax.random.PRNGKey(0), batch["image"], _prompts(batch),
                True))
        out[kind] = (jm, random_params(shapes["params"], seed=3))
    return out


def _port_model(kind, params):
    model = port_sam_matting.SAMMatting(
        sam=MODELS.create("sam_b", image_size=IMG, dtype=torch.float32,
                          **TINY_SAM),
        multi_level=KINDS[kind][0], dtype=torch.float32)
    return load_jax_params(model, params)


def test_weights_carry_both_ways(models):
    _, params = models["matting2"]
    model = _port_model("matting2", params)
    paths = jax_paths(model)
    assert paths["sam.image_encoder.blocks.1.attn.rel_pos_h"] == \
        "sam/image_encoder/blocks_1/attn/rel_pos_h"
    assert paths["fusion_pred_3.local_combine.weight"] == \
        "fusion_pred_3/local_combine/kernel"
    got = flatten_tree(export_jax_params(model))
    for path, w in flatten_tree(params).items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def _targets(batch):
    """(alpha, trimap, fg_map, bg_map) as the train CLIs make them."""
    image, alpha = batch["image"], batch["alpha"]
    return (alpha, batch["trimap"], image * alpha[..., None],
            image * (1.0 - alpha[..., None]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_loss_and_gradients_match_jax(models, kind):
    jm, params = models[kind]
    batch = _batch()
    loss_name = KINDS[kind][1]
    jcrit = JAX_LOSSES.create(loss_name)
    jbatch = _to_jax(batch)

    def fn(p):
        outs = jm.apply({"params": p}, jbatch["image"], _prompts(jbatch),
                        True)
        terms = jcrit(jbatch["image"], outs, _targets(jbatch))
        return sum(terms.values()), (terms, outs)

    with jax_f32():
        (want, (wterms, wouts)), wgrad = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
    model = _port_model(kind, params).train()
    tbatch = _to_torch(batch)
    outs = model(tbatch["image"], _prompts(tbatch), True)
    lead = (1,) if kind == "matting1" else (1, 4)
    assert [tuple(o.shape) for o in outs] == [
        lead + (IMG, IMG, 3), lead + (IMG, IMG, 1), lead + (IMG, IMG, 1),
        (1, 1) if kind == "matting1" else (1, 4)]
    for got, w in zip(outs, wouts):
        w = np.asarray(w)
        np.testing.assert_allclose(got.detach().numpy(), w,
                                   atol=1e-4 * np.abs(w).max())
    terms = LOSSES.create(loss_name)(tbatch["image"], outs,
                                     _targets(tbatch))
    loss = sum(terms.values())
    assert set(terms) == set(wterms) and len(terms) == 8
    assert loss.item() == pytest.approx(float(want), rel=1e-4)
    for key, v in terms.items():
        assert v.item() == pytest.approx(float(wterms[key]), rel=1e-4,
                                         abs=1e-6), key
    loss.backward()
    got = flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))
    for path, w in flatten_tree(jax.tree.map(np.asarray, wgrad)).items():
        if path.endswith("positional_encoding_gaussian_matrix"):
            # a parameter in the JAX tree, a buffer in the port
            assert path not in got and not w.any(), path
            continue
        g = got[path]
        norm = np.linalg.norm(w)
        if path.endswith("k_proj/bias") or norm == 0:
            # a key bias's true gradient is 0 (the softmax ignores it)
            assert np.abs(g).max() <= 1e-5 + 1e-3 * np.abs(w).max(), path
            continue
        assert np.linalg.norm(g - w) <= 0.01 * norm, path
        assert np.dot(g.ravel(), w.ravel()) / (
            np.linalg.norm(g) * norm) > 0.9999, path


def test_registered_models():
    """sam_b_matting{1,2} are SAM-B and its heads; the LightSAM variants
    wait for their backbones."""
    for name, head in (("sam_b_matting1", "fusion_pred"),
                       ("sam_b_matting2", "fusion_pred_3")):
        for dtype in (torch.bfloat16, torch.float32):
            model = MODELS.create(name, image_size=IMG, dtype=dtype,
                                  **TINY_SAM)
            assert model.multi_level is (head != "fusion_pred")
            assert getattr(model, head).dtype == dtype
            assert model.sam.image_encoder.patch_embed.proj.dtype == dtype
    for name, bb in (("convformer_m36_sam_matting1", "MetaFormer"),
                     ("vanb0_light_sam_matting2", "VAN")):
        with torch.device("meta"):
            model = MODELS.create(name)
        assert type(model.sam.backbone).__name__ == bb
        assert model.multi_level is name.endswith("2")


# ---- the loss stacks ----

HW = 50   # 2500 pixels: the window edges 0.04 and 0.16 are whole counts


def _stack_inputs(seed=0):
    """Predictions [5, 4, 50, 50, c] and targets whose alpha > 0 areas are
    0, 100 (0.04, on two windows' edges), 50 (0.02), 1250 (0.5) and 2500
    (1.0, on the last window's open end) pixels."""
    rng = np.random.RandomState(seed)
    b, L = 5, 4
    g = rng.rand(b, L, HW, HW, 3).astype(np.float32)
    g[0, 0, 0, 0] = [0.0, 1.0, 0.5]
    l = rng.rand(b, L, HW, HW, 1).astype(np.float32)
    f = rng.rand(b, L, HW, HW, 1).astype(np.float32)
    iou = rng.rand(b, L).astype(np.float32)
    alpha = np.zeros((b, HW, HW), np.float32)
    for i, area in enumerate((0, 100, 50, 1250, 2500)):
        alpha[i].ravel()[:area] = rng.uniform(0.01, 1.0, area)
    trimap = rng.choice([0.0, 128.0, 255.0], size=(b, HW, HW)).astype(
        np.float32)
    images = rng.rand(b, HW, HW, 3).astype(np.float32)
    fg = images * alpha[..., None]
    bg = images * (1.0 - alpha[..., None])
    return images, (g, l, f, iou), (alpha, trimap, fg, bg)


@pytest.mark.parametrize("name", STACKS)
def test_loss_stacks_and_gradients_match_jax(name):
    images, preds, targets = _stack_inputs()
    if name == "SAMMattingOneLevelLoss":   # without the level axis
        preds = tuple(p[:, 0] for p in preds[:3]) + (preds[3][:, :1],)
    kwargs = dict(mask_threshold=0.5, composition_loss_weight=2.0)
    jl, pl = JAX_LOSSES.create(name, **kwargs), LOSSES.create(name, **kwargs)

    def fn(*p):
        terms = jl(jnp.asarray(images), p, tuple(map(jnp.asarray, targets)))
        return sum(terms.values()), terms

    with jax_f32():
        (_, wterms), wgrads = jax.jit(jax.value_and_grad(
            fn, argnums=(0, 1, 2, 3), has_aux=True))(
                *map(jnp.asarray, preds))
    tp = [torch.from_numpy(p).requires_grad_() for p in preds]
    terms = pl(torch.from_numpy(images), tuple(tp),
               tuple(map(torch.from_numpy, targets)))
    assert set(terms) == set(wterms) and len(terms) == 8
    for key, v in terms.items():
        assert v.item() == pytest.approx(float(wterms[key]), rel=1e-5,
                                         abs=1e-7), key
    sum(terms.values()).backward()
    for t, w in zip(tp, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w,
                                   atol=1e-5 * np.abs(w).max() + 1e-12)


def test_assign_gating_follows_the_windows():
    """The strict window tests: a sample's levels count where its ratio
    lies strictly inside; a sample with none drops out of the mean."""
    images, preds, targets = _stack_inputs()
    loss = LOSSES.create("SAMMattingMultiLevelAssignLoss")
    per_level = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    ratio = torch.tensor([0.0, 0.04, 0.02, 0.5, 1.0])
    # 0: no window; 0.04: only (0.01, 0.25); 0.02: (0, 0.04) and
    # (0.01, 0.25); 0.5: (0.04, 0.64) and (0.16, 1.0); 1.0: none
    want = (6.0 + (9.0 + 10.0) / 2 + (12.0 + 15.0) / 2) / 3
    assert loss._masked_reduce(per_level, ratio).item() == pytest.approx(
        want)
    assert loss._masked_reduce(per_level, torch.zeros(5)).item() == 0.0


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("raw", [False, True])
def test_collater_matches_jax_under_shared_seeds(seed, raw):
    """Normalised samples and raw 0-255 ones (divided only when their
    largest value is above 1.5), one of them empty of foreground."""
    ds = FakeHumanMattingDataset(3, 48, seed=seed,
                                 transform=None if raw else MattingNormalize())
    samples = [ds[i] for i in range(3)]
    samples[2]["alpha"] = np.zeros_like(samples[2]["alpha"])
    random.seed(seed)
    np.random.seed(seed)
    want = jax_data.SAMMattingCollater(resize=64)(
        [{k: np.copy(v) for k, v in s.items()} for s in samples])
    got = port_data.SAMMattingCollater(
        resize=64, rng=random.Random(seed),
        np_rng=np.random.RandomState(seed))(
        [{k: np.copy(v) for k, v in s.items()} for s in samples])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["prompt_point"][2] == -1).all()


# ---- the engine step and the CLIs ----

OPT = dict(name="AdamW", lr=1e-4, weight_decay=1e-3,
           global_weight_decay=False, no_weight_decay_layer_name_list=())
SCHED = dict(scheduler="CosineLR", lr=1e-4, epochs=4, warm_up_epochs=1,
             min_lr=1e-6)


def test_two_engine_steps_match_jax(models, jax_tool):
    """sam_b_matting1 and SAMMattingOneLevelLoss: two steps on two images,
    the losses to 1e-4 and every parameter to 3e-5 after each (the key
    biases to 5e-4: ``tests/test_torch_sam_task.py::_agree``)."""
    from test_torch_sam_task import _agree
    jm, params = models["matting1"]
    criterion = "SAMMattingOneLevelLoss"
    jcfg = jax_engine.EngineConfig()
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**OPT),
        jax_schedule.SchedulerConfig(**SCHED), 2, params)
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
    with jax_f32():
        jstep = jax_engine.make_train_step(
            jax_tool.make_loss_fn(jm, JAX_LOSSES.create(criterion)), tx,
            jcfg, donate=False)
    model = _port_model("matting1", params)
    pcfg = port_engine.EngineConfig()
    opt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**OPT),
        port_schedule.SchedulerConfig(**SCHED), 2, model, device="cpu")
    state = port_engine.create_train_state(model, opt, pcfg, device="cpu")
    step = port_engine.make_train_step(
        train_interactive_matting.make_loss_fn(LOSSES.create(criterion)),
        pcfg)
    for seed in (0, 1):
        batch = _batch(seed=seed)
        assert (batch["alpha"] > 0.5).any()
        with jax_f32():
            jstate, jmetrics = jstep(jstate, _to_jax(batch),
                                     jax.random.PRNGKey(0))
        state, metrics = step(state, _to_torch(batch))
        assert float(metrics["skipped"]) == 0.0
        for key, w in jmetrics.items():
            assert float(metrics[key]) == pytest.approx(float(w), rel=1e-4,
                                                        abs=1e-6), key
        _agree(export_jax_params(model), jstate.params)


def _recipe(work_dir, restore=True):
    """The experiment with 8 samples, one batch (its own 16)."""
    src = (RECIPE / "train_config.py").read_text()
    assert src.count("num_samples=16") == 1
    (work_dir / "train_config.py").write_text(
        src.replace("num_samples=16", "num_samples=8"))
    test = (RECIPE / "test_config.py").read_text()
    old = 'trained_model_path = ""'
    assert old in test
    if restore:
        test = test.replace(old, 'trained_model_path = os.path.join('
                            'os.path.dirname(os.path.abspath(__file__)), '
                            '"checkpoints", "best")')
    (work_dir / "test_config.py").write_text(test)


def test_train_and_test_clis_on_the_cpu(tmp_path, monkeypatch):
    """No test set in the train config: the best is minus the loss; the
    test CLI evaluates the restored best on the train set."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _recipe(tmp_path)
    argv = ["--work-dir", str(tmp_path)]
    best = train_interactive_matting.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 1/1" in log and "fused_pred_iou_predict" not in log
    assert (tmp_path / "checkpoints" / "best").is_file() and best < 0
    stats = test_interactive_matting.main(argv)
    assert set(stats) == {"sad", "mae", "mse", "key_metric"}
    assert stats["key_metric"] == -stats["sad"] < 0


@pytest.mark.parametrize("cli", [train_interactive_matting,
                                 test_interactive_matting],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _recipe(tmp_path, restore=False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
