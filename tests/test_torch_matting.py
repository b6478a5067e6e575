"""The port's human matting (``simpleaicv_tpu_torch/losses/matting.py``,
``data/matting.py``, ``tasks/matting.py``, ``tools/{train,test}_human_
matting.py``) against the JAX package's on the CPU, in f32:

* the seven losses to 1e-5 relative (f32 sums in other orders) and their
  gradients to 1e-5 of their scale, with predictions at the clamp, alpha
  equal to the prediction (the Charbonnier's d = 0) and pyramids whose
  depth is clamped;
* the OpenCV-free pieces against OpenCV: the resizes (bilinear to 2e-5,
  nearest exact), the blur to 1e-6, the elliptic element, erosion and
  dilation exactly, and the filled ellipse on 800 draws (774 exact, the
  other 26 within 23 pixels);
* ``FakeHumanMattingDataset`` against the JAX one, the flip under shared
  seeds and the collater bit for bit;
* the task's loss and evaluation, and three PFAN matting engine steps
  (the seven-loss stack, AdamW, CosineLR) against the JAX steps;
* the train and test CLIs on ``fake_synthetic/resnet18_pfan_matting``.
"""

from pathlib import Path

import cv2
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
from simpleaicv_tpu.data import matting as jax_data
from simpleaicv_tpu.tasks import matting as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data import matting as port_data
from simpleaicv_tpu_torch.tasks import matting as port_task
from simpleaicv_tpu_torch.tools import test_human_matting, train_human_matting

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

REPO = Path(__file__).resolve().parent.parent
RECIPE = (REPO / "experiments/7.human_matting_training/fake_synthetic/"
          "resnet18_pfan_matting")
LOSS_NAMES = ("GlobalTrimapCELoss", "GloabelTrimapIouLoss", "LocalAlphaLoss",
              "LocalLaplacianLoss", "FusionAlphaLoss", "FusionLaplacianLoss",
              "CompositionLoss")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _targets(seed, b=2, hw=(20, 24)):
    """(global, local, fused predictions, alpha, trimap, image): some
    predictions beyond the clamp, the fused alpha equal to the alpha on a
    patch, the trimap's three codes."""
    rng = np.random.RandomState(seed)
    g = rng.rand(b, *hw, 3).astype(np.float32)
    g[0, 0, :4] = [0.0, 1.0, 0.5]
    l = rng.rand(b, *hw, 1).astype(np.float32)
    l[1, :2, :2] = 1.0
    alpha = rng.rand(b, *hw).astype(np.float32)
    alpha[:, :3] = 0.0
    f = rng.rand(b, *hw, 1).astype(np.float32)
    f[:, 5:8, 5:8, 0] = alpha[:, 5:8, 5:8]
    trimap = rng.choice([0.0, 128.0, 255.0], size=(b, *hw)).astype(
        np.float32)
    image = rng.rand(b, *hw, 3).astype(np.float32)
    return g, l, f, alpha, trimap, image


def _call(loss, name, g, l, f, alpha, trimap, image):
    if name.startswith(("Global", "Gloabel")):
        return loss(g, trimap)
    if name.startswith("Local"):
        return loss(l, alpha, trimap)
    if name.startswith("Composition"):
        return loss(f, alpha, image)
    return loss(f, alpha)


@pytest.mark.parametrize("hw", [(20, 24), (64, 64), (5, 40)])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_losses_and_gradients_match_jax(name, hw):
    """(5, 40) clamps the pyramid to 2 levels, (20, 24) to 4, (64, 64)
    keeps 5."""
    g, l, f, alpha, trimap, image = _targets(0, hw=hw)
    jloss, ploss = JAX_LOSSES.create(name), LOSSES.create(name)
    pred_index = 0 if name.startswith("Glo") else 1 if name.startswith(
        "Local") else 2

    def jfn(*preds):
        return _call(jloss, name, *preds, jnp.asarray(alpha),
                     jnp.asarray(trimap), jnp.asarray(image))

    preds = [jnp.asarray(x) for x in (g, l, f)]
    want, jgrad = jax.jit(jax.value_and_grad(jfn, argnums=pred_index))(
        *preds)
    tpreds = [torch.from_numpy(x).requires_grad_() for x in (g, l, f)]
    got = _call(ploss, name, *tpreds, torch.from_numpy(alpha),
                torch.from_numpy(trimap), torch.from_numpy(image))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5, abs=1e-7)
    jgrad, pgrad = np.array(jgrad), tpreds[pred_index].grad.numpy()
    if name in ("FusionAlphaLoss", "CompositionLoss"):
        # the Charbonnier's gradient is 0 where the fused alpha equals the
        # alpha; XLA's jitted composition (a fused multiply-add) leaves a
        # difference of ~1e-8 there, and a gradient of ~1e-2 of its scale
        assert not pgrad[:, 5:8, 5:8].any()
        jgrad[:, 5:8, 5:8] = 0.0
    np.testing.assert_allclose(pgrad, jgrad,
                               atol=1e-5 * np.abs(jgrad).max() + 1e-12)


def test_gauss_kernel_is_the_jax_packages():
    from simpleaicv_tpu.losses.matting import _gauss_kernel as jax_kernel
    from simpleaicv_tpu_torch.losses.matting import _gauss_kernel
    np.testing.assert_array_equal(_gauss_kernel(), jax_kernel())
    # k[i, j] is proportional to exp(-(i-2)^2) + exp(-(j-2)^2), summed: a
    # corner is e^-4 of the centre (the product's would be e^-8)
    k = _gauss_kernel()
    assert k[0, 0] / k[2, 2] == pytest.approx(np.exp(-4.0), rel=1e-5)


@pytest.mark.parametrize("src,dst", [(96, 64), (64, 96), (50, 64),
                                     (64, 64), (37, 16)])
def test_resize_matches_opencv(src, dst):
    rng = np.random.RandomState(src)
    sample = {"image": rng.uniform(0, 255, (src, src, 3)).astype(np.float32),
              "alpha": rng.rand(src, src).astype(np.float32),
              "trimap": rng.choice([0.0, 128.0, 255.0],
                                   (src, src)).astype(np.float32)}
    want = jax_data.MattingResize(dst)({k: v.copy()
                                        for k, v in sample.items()})
    got = port_data.MattingResize(dst)({k: v.copy()
                                        for k, v in sample.items()})
    np.testing.assert_allclose(got["image"], want["image"], atol=2e-5 * 255)
    np.testing.assert_allclose(got["alpha"], want["alpha"], atol=2e-5)
    np.testing.assert_array_equal(got["trimap"], want["trimap"])
    assert set(np.unique(got["trimap"])) <= {0.0, 128.0, 255.0}
    np.testing.assert_array_equal(got["size"], want["size"])


def test_blur_and_morphology_match_opencv():
    rng = np.random.RandomState(1)
    for shape in ((64, 64), (31, 47), (7, 9)):
        x = rng.rand(*shape).astype(np.float32)
        np.testing.assert_allclose(port_data.gaussian_blur(x, 7, 2.0),
                                   cv2.GaussianBlur(x, (7, 7), 2.0),
                                   atol=1e-6)
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
        np.testing.assert_array_equal(port_data.ellipse_element(5), k)
        m = (x > 0.3).astype(np.uint8)
        np.testing.assert_array_equal(port_data.erode(m, k),
                                      cv2.erode(m, k))
        np.testing.assert_array_equal(port_data.dilate(m, k),
                                      cv2.dilate(m, k))


def test_filled_ellipse_matches_opencv():
    """The dataset's draws at four sizes, 200 each: the pixels that differ
    from ``cv2.ellipse`` are counted. 774 of the 800 are exact; each of
    the other 26 is within 23 pixels, and all but one of them (1 pixel)
    has an outline edge that leaves the canvas, which OpenCV clips before
    drawing it; 0.09 pixels a draw on average."""
    diffs = []
    for hw in (64, 96, 256, 1024):
        for seed in range(200):
            rng = np.random.RandomState(seed)
            cy, cx = rng.randint(hw // 4, 3 * hw // 4, 2)
            ay, ax = rng.randint(hw // 6, hw // 3, 2)
            angle = rng.uniform(0, 180)
            want = np.zeros((hw, hw), np.float32)
            cv2.ellipse(want, (cx, cy), (ax, ay), angle, 0, 360, 1.0, -1)
            got = port_data.fill_ellipse(np.zeros((hw, hw), np.float32),
                                         (cx, cy), (ax, ay), angle, 1.0)
            diffs.append(int((got != want).sum()))
    diffs = np.array(diffs)
    assert (diffs == 0).sum() >= 774 and diffs.max() <= 23
    assert diffs.mean() <= 0.1


@pytest.mark.parametrize("hw,seed", [(64, 0), (96, 0), (96, 1)])
def test_fake_dataset_matches_jax(hw, seed):
    """Image, alpha and trimap of 16 samples: the alpha to 2e-6 (the
    blur's rounding) where the filled ellipses agree, and no trimap pixel
    apart."""
    jds = jax_data.FakeHumanMattingDataset(16, hw, seed=seed)
    pds = port_data.FakeHumanMattingDataset(16, hw, seed=seed)
    assert len(pds) == len(jds) == 16
    for i in range(16):
        want, got = jds[i], pds[i]
        assert set(got) == set(want)
        np.testing.assert_allclose(got["alpha"], want["alpha"], atol=2e-6)
        np.testing.assert_allclose(got["image"], want["image"], atol=1e-3)
        np.testing.assert_array_equal(got["trimap"], want["trimap"])
        for key in ("scale", "size"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["image"].dtype == got["alpha"].dtype == np.float32


@pytest.mark.parametrize("seed", range(4))
def test_flip_matches_jax_under_shared_seeds(seed):
    sample = port_data.FakeHumanMattingDataset(1, 32)[0]
    np.random.seed(seed)
    want = jax_data.MattingRandomHorizontalFlip(0.5)(
        {k: np.copy(v) for k, v in sample.items()})
    got = port_data.MattingRandomHorizontalFlip(
        0.5, np_rng=np.random.RandomState(seed))(
        {k: np.copy(v) for k, v in sample.items()})
    for key in ("image", "alpha", "trimap"):
        np.testing.assert_array_equal(got[key], want[key])


def test_collater_and_normalize_are_bit_exact():
    samples = [port_data.FakeHumanMattingDataset(3, hw)[i]
               for hw, i in ((48, 0), (64, 1), (40, 2))]
    norm_j, norm_p = jax_data.MattingNormalize(), port_data.MattingNormalize()
    want = jax_data.HumanMattingCollater(64)(
        [norm_j({k: np.copy(v) for k, v in s.items()}) for s in samples])
    got = port_data.HumanMattingCollater(64)(
        [norm_p({k: np.copy(v) for k, v in s.items()}) for s in samples])
    assert set(got) == set(want) == {"image", "alpha", "trimap"}
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])


# ---- the task and the engine step on a tiny PFAN matting model ----

IMG = 64
OPT = dict(name="AdamW", lr=3e-4, weight_decay=1e-3,
           global_weight_decay=False, no_weight_decay_layer_name_list=())
SCHED = dict(scheduler="CosineLR", lr=3e-4, epochs=4, min_lr=1e-6)
STEPS = 3


def _batches(n=STEPS):
    ds = port_data.FakeHumanMattingDataset(2 * n, 80, transform=lambda s: (
        port_data.MattingNormalize()(port_data.MattingResize(IMG)(s))))
    collate = port_data.HumanMattingCollater(IMG)
    return [collate([ds[2 * i], ds[2 * i + 1]]) for i in range(n)]


@pytest.fixture(scope="module")
def variables():
    with jax_f32():
        model = JAX_MODELS.create("resnet18_pfan_matting")
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), False))
    return {"params": random_params(shapes["params"], seed=7),
            "batch_stats": random_batch_stats(shapes["batch_stats"],
                                              seed=8)}


def _port_model(variables):
    return load_jax_params(
        MODELS.create("resnet18_pfan_matting", dtype=torch.float32),
        variables["params"], batch_stats=variables["batch_stats"])


def _criteria(registry):
    return {name: (1.0, registry.create(name)) for name in LOSS_NAMES}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_fn_matches_jax(variables):
    batch = _batches(1)[0]
    jmodel = JAX_MODELS.create("resnet18_pfan_matting")
    with jax_f32():
        want, (wterms, _) = jax.jit(
            jax_task.make_loss_fn(jmodel, _criteria(JAX_LOSSES)),
            static_argnums=4)(variables["params"],
                              {"batch_stats": variables["batch_stats"]},
                              jax.tree.map(jnp.asarray, batch),
                              jax.random.PRNGKey(0), False)
    model = _port_model(variables).eval()
    with torch.no_grad():
        got, terms = port_task.make_loss_fn(_criteria(LOSSES))(
            model, _to_torch(batch), None, False)
    assert set(terms) == set(wterms) == set(LOSS_NAMES)
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    for name, v in terms.items():
        assert v.item() == pytest.approx(float(wterms[name]), rel=1e-5,
                                         abs=1e-7), name


def test_evaluator_matches_jax(variables):
    batches = _batches(2)
    jmodel = JAX_MODELS.create("resnet18_pfan_matting")
    with jax_f32():
        want = jax_task.make_evaluate()(
            jax_engine.make_eval_step(jax_task.make_eval_fn(jmodel)),
            jax.tree.map(jnp.asarray, variables["params"]),
            {"batch_stats": variables["batch_stats"]}, batches,
            lambda b: jax.tree.map(jnp.asarray, b))
    got = port_task.make_evaluate()(
        port_engine.make_eval_step(port_task.make_eval_fn(), device="cpu"),
        _port_model(variables), batches, _to_torch)
    assert set(got) == set(want) == {"sad", "mae", "mse", "key_metric"}
    for key, w in want.items():
        assert got[key] == pytest.approx(w, rel=1e-5), key
    assert got["key_metric"] == -got["sad"] < 0


# BatchNorms whose output meets only a 1x1 convolution and a train-mode
# BatchNorm, which removes any per-channel constant: their bias gradient is
# exactly 0 and both sides' rounding noise, which AdamW turns into steps of
# at most lr either way (tests/test_torch_segmentation_task.py)
ZERO_GRADIENT = tuple(f"{d}/{c}/bn/bias"
                      for d in ("global_decoder", "local_decoder")
                      for c in ("high_level_conv", "low_level_conv"))


def test_gradients_match_jax(variables):
    """The train-mode gradient of the seven-loss stack on one batch: every
    leaf within 2% of JAX's in L2 at a cosine above 0.9999 (the largest
    part by 0.55%), the leaves of ``ZERO_GRADIENT`` at most 1e-7 on
    either side."""
    batch = _batches(1)[0]
    jmodel = JAX_MODELS.create("resnet18_pfan_matting")
    loss_fn = jax_task.make_loss_fn(jmodel, _criteria(JAX_LOSSES))
    with jax_f32():
        want = jax.jit(jax.grad(lambda p: loss_fn(
            p, {"batch_stats": variables["batch_stats"]},
            jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0),
            True)[0]))(variables["params"])
    model = _port_model(variables).train()
    loss, _ = port_task.make_loss_fn(_criteria(LOSSES))(
        model, _to_torch(batch), None, True)
    loss.backward()
    got = flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))
    want = flatten_tree(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if path in ZERO_GRADIENT:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-7, path
            continue
        norm = np.linalg.norm(w)
        assert np.linalg.norm(g - w) <= 0.02 * norm, path
        assert np.dot(g.ravel(), w.ravel()) / (
            np.linalg.norm(g) * norm) > 0.9999, path


def _stats_agree(model, jstate, tol, relative=False):
    """The BatchNorm statistics against the JAX step's: each element to
    ``tol``, or each leaf to ``tol`` of its largest value."""
    want = flatten_tree(jax.tree.map(np.asarray,
                                     jstate.state_vars["batch_stats"]))
    got = flatten_tree(export_jax_batch_stats(model))
    assert set(got) == set(want)
    for path, w in want.items():
        bound = tol * np.abs(w).max() if relative else tol * (1 + np.abs(w))
        assert (np.abs(got[path] - w) <= bound).all(), path


def test_three_engine_steps_track_jax(variables):
    """Three AdamW steps: the first step's losses to 1e-4 relative and the
    later ones' to 3e-3, the whole change of the parameters within 15% of
    JAX's in L2 at a cosine above 0.99 and no element apart by more than
    2 lr a step, the BatchNorm statistics after the first step to 2e-4 and
    after the third to 5% of each leaf's largest value (3.2% at most
    here). AdamW moves an element
    by about lr whatever its gradient's size, so where train-mode
    BatchNorm at batch 2 leaves a gradient element within rounding of 0
    the two sides step by lr in opposite ways, and the fused alpha's
    trimap argmax moves with the weights (``test_gradients_match_jax``
    holds the gradients themselves; after three steps 0.9% of the elements
    are apart by more than lr, the whole change by 11.4%, at a cosine of
    0.9935)."""
    batches = _batches()
    jmodel = JAX_MODELS.create("resnet18_pfan_matting")
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**OPT), jax_schedule.SchedulerConfig(
            **SCHED), 2, variables["params"])
    jcfg = jax_engine.EngineConfig()
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, variables["params"]),
        {"batch_stats": jax.tree.map(jnp.asarray,
                                     variables["batch_stats"])}, tx, jcfg)
    with jax_f32():
        jstep = jax_engine.make_train_step(
            jax_task.make_loss_fn(jmodel, _criteria(JAX_LOSSES)), tx, jcfg,
            donate=False)
    model = _port_model(variables)
    opt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**OPT),
        port_schedule.SchedulerConfig(**SCHED), 2, model, device="cpu")
    state = port_engine.create_train_state(model, opt,
                                           port_engine.EngineConfig(),
                                           device="cpu")
    step = port_engine.make_train_step(
        port_task.make_loss_fn(_criteria(LOSSES)),
        port_engine.EngineConfig())
    for i, batch in enumerate(batches):
        with jax_f32():
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(0))
        state, pm = step(state, _to_torch(batch))
        assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
        for key in jm:
            if key != "skipped":
                assert float(pm[key]) == pytest.approx(
                    float(jm[key]), rel=1e-4 if i == 0 else 3e-3), (i, key)
        if i == 0:  # the statistics of the first forward: the same weights
            _stats_agree(model, jstate, 2e-4)
    assert state.step == int(jstate.step) == STEPS
    got, want, start = (flatten_tree(t) for t in (
        export_jax_params(model), jax.tree.map(np.asarray, jstate.params),
        variables["params"]))
    assert set(got) == set(want)
    dg = np.concatenate([(got[p] - start[p]).ravel() for p in sorted(want)])
    dw = np.concatenate([(want[p] - start[p]).ravel() for p in sorted(want)])
    assert np.abs(dg - dw).max() <= 2 * STEPS * OPT["lr"] * (1 + 1e-2)
    assert np.linalg.norm(dg - dw) <= 0.15 * np.linalg.norm(dw)
    assert np.dot(dg, dw) / (np.linalg.norm(dg) * np.linalg.norm(dw)) > 0.99
    _stats_agree(model, jstate, 0.05, relative=True)


# ---- the CLIs ----

def _shrunk_recipe(work_dir, restore=True):
    """The experiment with 16 train and 8 test samples (its own 32 and 8)
    and 1 epoch; the test config restores checkpoints/best."""
    src = (RECIPE / "train_config.py").read_text()
    for old, new in (("num_samples=32", "num_samples=16"),
                     ("epochs = 2", "epochs = 1")):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (RECIPE / "test_config.py").read_text()
    old = 'trained_model_path = ""'
    assert old in test
    if restore:
        test = test.replace(old, 'trained_model_path = os.path.join('
                            'os.path.dirname(os.path.abspath(__file__)), '
                            '"checkpoints", "best")')
    (work_dir / "test_config.py").write_text(test)


def test_train_and_test_clis_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _shrunk_recipe(tmp_path)
    argv = ["--work-dir", str(tmp_path)]
    best = train_human_matting.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 2/2" in log and "epoch 1 eval: {'sad': " in log
    assert (tmp_path / "checkpoints" / "best").is_file()
    stats = test_human_matting.main(argv)
    assert set(stats) == {"sad", "mae", "mse", "key_metric"}
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


@pytest.mark.parametrize("cli", [train_human_matting, test_human_matting],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, cli):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _shrunk_recipe(tmp_path, restore=False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
