"""The port's LightSAM and SAM distillation (``simpleaicv_tpu_torch/models/
interactive_segmentation/light_sam.py``, ``tools/train_interactive_
segmentation_distill{,_sam}.py``) against the JAX package's on the CPU, in
f32:

* ``SAMFPN`` and ``LightSAM`` over a ResNet-18's features at 256^2, in
  train mode: the masks and IoUs to 1e-4 of their scale, the new BatchNorm
  statistics to 1e-5, every gradient within 5% of JAX's in L2 at a cosine
  above 0.999 (train-mode BatchNorm at batch 2 amplifies the f32 rounding
  toward the stem: its convolution's gradient parts by 2.4%, at a cosine
  of 0.99974; the SAM parts by less);
* both distillation models' parameter trees against the JAX trees (the
  encoder distillation's holds the two image encoders only, neither holds
  the mask-prompt convolutions), their forwards, and the teacher without a
  gradient;
* two engine steps of each through its CLI's loss function against the
  JAX CLI's (AdamW with weight decay): the encoder distillation's teacher,
  not frozen, moves by its weight decay alone as in JAX, the whole-SAM
  distillation's teacher, frozen by ``frozen_layer_name_list``, not at all;
* both CLIs on ``fake_synthetic/tiny_sam_{encoder_,}distill``.
"""

import importlib.util
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
from simpleaicv_tpu.models.interactive_segmentation import \
    light_sam as jax_light_sam
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data.interactive_segmentation import (
    FakeSAMSegmentationDataset, SAMBatchCollater)
from simpleaicv_tpu_torch.models.interactive_segmentation import \
    light_sam as port_light_sam
from simpleaicv_tpu_torch.tools import (
    train_interactive_segmentation_distill as encoder_cli,
    train_interactive_segmentation_distill_sam as sam_cli)

from _torch_port import (TINY_SAM, flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)
from test_torch_sam_task import _agree

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments/13.interactive_segmentation_training/"
IMG = 256
LIGHT = dict(backbone_type="resnet18", image_size=IMG,
             prompt_encoder_embedding_planes=64)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _load_jax_tool(name):
    """The JAX package's tools/<name>.py as a module (it imports its
    sibling ``common``)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", REPO / "tools" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "tools"))
        sys.modules.pop("common", None)
    return module


def _batch(n=1, seed=0):
    """``n`` synthetic 256^2 samples through the port's collater."""
    ds = FakeSAMSegmentationDataset(n + seed, IMG)
    collate = SAMBatchCollater(resize=IMG, max_points=4,
                               positive_point_num_range=(1, 3))
    return collate([ds[i] for i in range(seed, seed + n)])


def _prompts(batch, lib=np):
    return {"prompt_point": lib.asarray(batch["prompt_point"]),
            "prompt_box": lib.asarray(batch["prompt_box"]),
            "prompt_mask": None}


def _tprompts(batch):
    return {"prompt_point": torch.from_numpy(batch["prompt_point"]),
            "prompt_box": torch.from_numpy(batch["prompt_box"]),
            "prompt_mask": None}


# ---- LightSAM over ResNet-18 ----

def test_light_sam_matches_jax():
    batch = _batch(2)
    image = jnp.asarray(batch["image"])
    jm = jax_light_sam.LightSAM(**LIGHT)
    with jax_f32():
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), image, _prompts(batch, jnp),
            (0, 1, 2, 3), True))
    params = random_params(shapes["params"], seed=2)
    stats = random_batch_stats(shapes["batch_stats"], seed=3)

    def fn(p):
        (masks, ious), new = jm.apply(
            {"params": p, "batch_stats": stats}, image, _prompts(batch, jnp),
            (0, 1, 2, 3), True, mutable=["batch_stats"])
        return jnp.mean(masks**2) + jnp.sum(ious), (masks, ious, new)

    with jax_f32():
        (_, (wmasks, wious, wnew)), wgrad = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
    # initialised without a mask prompt, the JAX tree has no mask convolutions
    model = load_jax_params(port_light_sam.drop_mask_prompt(
        port_light_sam.LightSAM(dtype=torch.float32, **LIGHT)), params,
        batch_stats=stats).train()
    assert sorted(flatten_tree(export_jax_params(model))) == sorted(
        flatten_tree(params))
    masks, ious = model(torch.from_numpy(batch["image"]), _tprompts(batch),
                        train=True)
    assert masks.shape == (2, 4, IMG, IMG) and ious.shape == (2, 4)
    for got, want in ((masks, wmasks), (ious, wious)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
    got_stats = flatten_tree(export_jax_batch_stats(model))
    for path, w in flatten_tree(wnew["batch_stats"]).items():
        np.testing.assert_allclose(got_stats[path], np.asarray(w),
                                   atol=1e-5, rtol=1e-5, err_msg=path)
    ((masks**2).mean() + ious.sum()).backward()
    got = flatten_tree(export_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()}))
    for path, w in flatten_tree(jax.tree.map(np.asarray, wgrad)).items():
        if path.endswith("positional_encoding_gaussian_matrix"):
            assert path not in got and not w.any()  # a buffer in the port
            continue
        g, norm = got[path], np.linalg.norm(w)
        if path.endswith("k_proj/bias") or norm == 0:
            assert np.abs(g).max() <= 1e-5 + 1e-3 * np.abs(w).max(), path
            continue
        assert np.linalg.norm(g - w) <= 0.05 * norm, path
        assert np.dot(g.ravel(), w.ravel()) / (
            np.linalg.norm(g) * norm) > 0.999, path


def test_light_sam_variants_wait_for_their_backbones():
    """The VAN and ConvFormer variants, which waited for their backbones,
    build on them (their trees: ``tests/test_torch_backbone_variants.py``)."""
    for name, bb in (("convformer_m36_light_sam", "MetaFormer"),
                     ("vanb3_light_sam", "VAN")):
        with torch.device("meta"):
            assert type(MODELS.create(name).backbone).__name__ == bb
    assert isinstance(port_light_sam.LightSAM(**LIGHT).fpn,
                      port_light_sam.SAMFPN)


# ---- the distillation models ----

def _sams(lib_models, dtype=None):
    extra = {} if dtype is None else {"dtype": dtype}
    return [lib_models.create("sam_b", image_size=IMG, **TINY_SAM, **extra)
            for _ in range(2)]


KINDS = {
    "encoder": dict(jax_cls=jax_light_sam.SAMDistillEncoderModel,
                    port_cls=port_light_sam.SAMDistillEncoderModel,
                    tool="train_interactive_segmentation_distill",
                    cli=encoder_cli, loss="SAMDistillMSELoss", frozen=()),
    "sam": dict(jax_cls=jax_light_sam.SAMDistillModel,
                port_cls=port_light_sam.SAMDistillModel,
                tool="train_interactive_segmentation_distill_sam",
                cli=sam_cli, loss="SAMDistillLoss", frozen=("teacher",)),
}


def _jax_init(kind, jm, batch):
    image = jnp.asarray(batch["image"])
    with jax_f32():
        if kind == "encoder":
            return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                  image, True))
        return jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), image, _prompts(batch, jnp),
            (0, 1, 2, 3), True))


@pytest.fixture(scope="module")
def distill():
    """{kind: (JAX model, seeded params)}."""
    batch = _batch()
    out = {}
    for kind, spec in KINDS.items():
        jm = spec["jax_cls"](*_sams(JAX_MODELS))
        out[kind] = (jm, random_params(_jax_init(kind, jm, batch)["params"],
                                       seed=5))
    return out


def _port_model(kind, params):
    model = KINDS[kind]["port_cls"](*_sams(MODELS, torch.float32))
    return load_jax_params(model, params)


def test_distill_trees_are_the_jax_trees(distill):
    """The encoder distillation: the two image encoders only; the whole-SAM
    one: both SAMs without mask-prompt convolutions."""
    _, enc = distill["encoder"]
    assert sorted(enc) == ["student", "teacher"]
    assert sorted(enc["teacher"]) == sorted(enc["student"]) == \
        ["image_encoder"]
    _, full = distill["sam"]
    assert sorted(full["student"]) == ["image_encoder", "mask_decoder",
                                       "prompt_encoder"]
    assert not any("mask_conv" in k for k in full["teacher"]
                   ["prompt_encoder"])
    for kind, (_, params) in distill.items():
        got = flatten_tree(export_jax_params(_port_model(kind, params)))
        # the random Fourier matrix is a buffer in the port
        want = {k: v for k, v in flatten_tree(params).items()
                if not k.endswith("positional_encoding_gaussian_matrix")}
        assert set(got) - set(want) <= {
            k for k in got if k.endswith("positional_encoding_gaussian_"
                                         "matrix")}
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_distill_forward_matches_jax(distill, kind):
    jm, params = distill[kind]
    batch = _batch()
    model = _port_model(kind, params).train()
    image = torch.from_numpy(batch["image"])
    with jax_f32():
        if kind == "encoder":
            want = jax.jit(lambda p, x: jm.apply({"params": p}, x, True))(
                params, jnp.asarray(batch["image"]))
            got = model(image, True)
        else:
            want = jax.jit(lambda p, x, pr: jm.apply(
                {"params": p}, x, pr, (0, 1, 2, 3), True))(
                    params, jnp.asarray(batch["image"]), _prompts(batch, jnp))
            got = model(image, _tprompts(batch), (0, 1, 2, 3), True)
    flat_got = jax.tree.leaves(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want) == (2 if kind == "encoder" else 4)
    for g, w in zip(flat_got, flat_want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w,
                                   atol=1e-4 * np.abs(w).max())
    assert not flat_got[0].requires_grad and flat_got[-1].requires_grad
    assert model.training and model.teacher.training


OPT = dict(name="AdamW", lr=3e-4, weight_decay=1e-3,
           global_weight_decay=False, no_weight_decay_layer_name_list=())
SCHED = dict(scheduler="CosineLR", lr=3e-4, epochs=2)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_two_engine_steps_match_jax(distill, kind):
    """Each CLI's loss function on both engines, two steps on two images
    with the tiny configs' AdamW: the losses to 1e-4, every parameter to
    3e-5 after each step (``test_torch_sam_task._agree``); the teacher's
    change is its weight decay alone, or none when it is frozen."""
    spec = KINDS[kind]
    jm, params = distill[kind]
    opt = dict(OPT, frozen_layer_name_list=spec["frozen"])
    jcfg = jax_engine.EngineConfig()
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**opt),
        jax_schedule.SchedulerConfig(**SCHED), 2, params)
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
    with jax_f32():
        jstep = jax_engine.make_train_step(
            _load_jax_tool(spec["tool"]).make_loss_fn(
                jm, JAX_LOSSES.create(spec["loss"])), tx, jcfg, donate=False)
    model = _port_model(kind, params)
    pcfg = port_engine.EngineConfig()
    popt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**SCHED), 2, model, device="cpu")
    state = port_engine.create_train_state(model, popt, pcfg, device="cpu")
    step = port_engine.make_train_step(
        spec["cli"].make_loss_fn(LOSSES.create(spec["loss"])), pcfg)
    for seed in (0, 1):
        batch = _batch(seed=seed)
        with jax_f32():
            jstate, jm_ = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                jax.random.PRNGKey(0))
        state, pm = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        assert float(pm["skipped"]) == 0.0
        for key, w in jm_.items():
            assert float(pm[key]) == pytest.approx(float(w), rel=1e-4,
                                                   abs=1e-6), key
        _agree(export_jax_params(model), jstate.params)
    start = flatten_tree(params)
    got = flatten_tree(export_jax_params(model))
    kernel = "teacher/image_encoder/blocks_0/attn/qkv/kernel"
    if spec["frozen"]:
        np.testing.assert_array_equal(got[kernel], start[kernel])
    else:   # two AdamW steps on a zero gradient: the decay alone
        lrs = [port_optim.current_lr(
            port_optim.OptimizerConfig(**opt),
            port_schedule.SchedulerConfig(**SCHED), 2, i) for i in (0, 1)]
        want = start[kernel] * np.prod([1 - lr * 1e-3 for lr in lrs])
        np.testing.assert_allclose(got[kernel], want, rtol=1e-6, atol=1e-9)
        assert not np.array_equal(got[kernel], start[kernel])


# ---- the CLIs ----

CONFIGS = {"encoder": "tiny_sam_encoder_distill", "sam": "tiny_sam_distill"}


def _recipe(work_dir, kind):
    """The experiment on 8 of its 16 samples (one batch), 1 epoch."""
    src = (EXPERIMENTS / "fake_synthetic" / CONFIGS[kind] /
           "train_config.py").read_text()
    old = "FakeSAMSegmentationDataset(\n        16,"
    assert src.count(old) == 1
    src = src.replace(old, "FakeSAMSegmentationDataset(\n        8,")
    src = src.replace("epochs = 2", "epochs = 1")
    (work_dir / "train_config.py").write_text(src)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cli_trains_on_the_cpu(tmp_path, monkeypatch, kind):
    """No evaluation: the best checkpoint has the least loss."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _recipe(tmp_path, kind)
    best = KINDS[kind]["cli"].main(["--work-dir", str(tmp_path)])
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 1/1" in log and "epoch 1 done" in log
    assert (tmp_path / "checkpoints" / "best").is_file()
    assert np.isfinite(best) and best < 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cli_raises_without_a_card(tmp_path, monkeypatch, kind):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _recipe(tmp_path, kind)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        KINDS[kind]["cli"].main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()
