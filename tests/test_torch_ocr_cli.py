"""The port's OCR CLIs and engine steps on the CPU.

The CLIs run shrunk copies of ``fake_synthetic/resnet18_dbnet`` (8 train
and 4 test images, batches of 4: an epoch with its polygon P/R/F1, a best
checkpoint, the test CLI restoring it and returning the same F1) and
``resnet18_ctc`` (16 and 8 strings, one epoch with its string metrics, the
test CLI restoring the best), and raise without a card unless the CPU is
asked for.

Three AdamW engine steps of each model at its recipe's lr (resnet18_dbnet
with a 64-wide pyramid at 64^2 at 3e-4, the resnet18 BiLSTM CTC model at
32 x 128 at 1e-3; batch 2, f32) track the JAX engine's on the same
batches and seeded weights. The first step's losses agree within 1e-5
relative and its parameter change as ``_torch_port.assert_updates_agree``
holds one AdamW step. Over the next two steps train-mode BatchNorm at
batch 2 and AdamW's sign-like steps blow rounding up, and the bounds are
set from readings beside a witness of that: the same JAX engine against
itself with every starting weight moved by 1 ulp. Its gaps at steps 2 and
3 (over every reported loss) and its final change's L2 gap and cosine,
as ``PERF.md`` lists them:

  DBNet, lr 3e-4: port 2.9e-5, 7.6e-4, 0.094, 0.9956;
                  JAX + 1 ulp 2.3e-5, 2.8e-4, 0.066, 0.9978;
  CTC, lr 1e-3:   port 1.0e-4, 4.2e-3, 0.169, 0.9858;
                  JAX + 1 ulp 6.2e-6, 3.3e-3, 0.169, 0.9857.

The bounds (``TRACK``) sit at two to three times the larger reading."""

import importlib.util
import re
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
from simpleaicv_tpu.models import text_recognition as jax_models
from simpleaicv_tpu.tasks import text_recognition as jax_rec_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import export_jax_params, \
    load_jax_params
from simpleaicv_tpu_torch.data import text_detection as det_data
from simpleaicv_tpu_torch.data import text_recognition as rec_data
from simpleaicv_tpu_torch.models import text_recognition as port_models
from simpleaicv_tpu_torch.tasks import text_detection as det_task
from simpleaicv_tpu_torch.tasks import text_recognition as rec_task
from simpleaicv_tpu_torch.tools import (test_text_detection,
                                        test_text_recognition,
                                        train_text_detection,
                                        train_text_recognition)

from _torch_port import (assert_updates_agree, flatten_tree, jax_f32,
                         one_torch_thread, random_batch_stats, random_params)

REPO = Path(__file__).resolve().parent.parent
EXPERIMENTS = REPO / "experiments"
DBNET = "8.ocr_text_detection_training/fake_synthetic/resnet18_dbnet"
CTC = "9.ocr_text_recognition_training/fake_synthetic/resnet18_ctc"
# config dir -> (train CLI, test CLI, the source's lines and the shrunk ones)
CASES = {
    DBNET: (train_text_detection, test_text_detection,
            [("FakeTextDetectionDataset(num_samples=16",
              "FakeTextDetectionDataset(num_samples=8"),
             ("batch_size = 8", "batch_size = 4")]),
    CTC: (train_text_recognition, test_text_recognition,
          [("FakeTextRecognitionDataset(64)",
            "FakeTextRecognitionDataset(16)"),
           ("epochs = 3", "epochs = 1")]),
}
BEST = ('trained_model_path = os.path.join(os.path.dirname('
        'os.path.abspath(__file__)), "checkpoints", "best")')
STEPS = 3
# family -> the recipe's lr, the loss bounds of steps 2 and 3, and the
# final change's L2 gap (relative) and least cosine
TRACK = {"detection": (3e-4, (1e-4, 2e-3), 0.2, 0.99),
         "recognition": (1e-3, (1e-3, 1e-2), 0.35, 0.97)}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _shrunk_recipe(work_dir, rel, restore=True):
    src = (EXPERIMENTS / rel / "train_config.py").read_text()
    for old, new in CASES[rel][2]:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (EXPERIMENTS / rel / "test_config.py").read_text()
    assert 'trained_model_path = ""' in test
    if restore:
        test = test.replace('trained_model_path = ""', BEST)
    (work_dir / "test_config.py").write_text(test)


def test_text_detection_clis_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _shrunk_recipe(tmp_path, DBNET)
    argv = ["--work-dir", str(tmp_path)]
    best = train_text_detection.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 2/2" in log and "imgs/s" in log
    assert re.search(r"epoch 1 eval: \{'precision': [-0-9.e]+, 'recall'",
                     log), log
    assert (tmp_path / "checkpoints" / "best").is_file()
    stats = test_text_detection.main(argv)
    assert set(stats) == {"precision", "recall", "f1", "key_metric"}
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


def test_text_recognition_clis_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    _shrunk_recipe(tmp_path, CTC)
    argv = ["--work-dir", str(tmp_path)]
    best = train_text_recognition.main(argv)
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 1 iter 2/2" in log
    assert "epoch 1 eval: {'str_acc': " in log, log
    assert (tmp_path / "checkpoints" / "best").is_file()
    stats = test_text_recognition.main(argv)
    assert set(stats) == {"str_acc", "lcs_precision", "lcs_recall",
                          "edit_distance_1ned", "key_metric"}
    assert stats["key_metric"] == pytest.approx(best, abs=1e-9)


@pytest.mark.parametrize("rel,which", [(r, w) for r in sorted(CASES)
                                       for w in (0, 1)])
def test_clis_raise_without_a_card(tmp_path, monkeypatch, rel, which):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    _shrunk_recipe(tmp_path, rel, restore=False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        CASES[rel][which].main(["--work-dir", str(tmp_path)])
    assert not (tmp_path / "checkpoints").exists()


# ---- engine steps against the JAX engine -----------------------------------

def _jax_detection_loss():
    """The JAX package's tools/train_text_detection.py's loss function
    factory (the module imports its sibling ``common``)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_train_text_detection", REPO / "tools" /
            "train_text_detection.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "tools"))
        sys.modules.pop("common", None)
    return module.make_loss_fn


@pytest.fixture(scope="module")
def jax_detection_loss():
    return _jax_detection_loss()


def _detection_case(jax_make_loss_fn):
    ds = det_data.FakeTextDetectionDataset(2 * STEPS, image_hw=64)
    collate = det_data.TextDetectionCollater(64)
    batches = [collate([ds[2 * i], ds[2 * i + 1]]) for i in range(STEPS)]
    batches = [{k: v for k, v in b.items() if k != "polys"}
               for b in batches]
    jmodel = JAX_MODELS.create("resnet18_dbnet", inter_planes=64)
    port = MODELS.create("resnet18_dbnet", inter_planes=64,
                         dtype=torch.float32)
    return (batches, jmodel, port,
            jax_make_loss_fn(jmodel, JAX_LOSSES.create("DBNetLoss")),
            det_task.make_loss_fn(LOSSES.create("DBNetLoss")))


def _recognition_case():
    conv = rec_data.CTCTextLabelConverter(list("0123456789"), 10)
    ds = rec_data.FakeTextRecognitionDataset(2 * STEPS)
    collate = rec_data.KeepRatioResizeTextRecognitionCollater(conv, 32, 128)
    batches = [collate([ds[2 * i], ds[2 * i + 1]]) for i in range(STEPS)]
    batches = [{k: v for k, v in b.items() if k != "texts"}
               for b in batches]
    kw = dict(backbone_type="resnet18", encoder_type="BiLSTMEncoder",
              predictor_hidden_planes=64, num_classes=11)
    jmodel = jax_models.CTCModel(**kw)
    port = port_models.CTCModel(dtype=torch.float32, **kw)
    return (batches, jmodel, port,
            jax_rec_task.make_loss_fn(jmodel, JAX_LOSSES.create("CTCLoss")),
            rec_task.make_loss_fn(LOSSES.create("CTCLoss")))


def _case(family, jax_make_loss_fn):
    case = (_detection_case(jax_make_loss_fn) if family == "detection"
            else _recognition_case())
    lr = TRACK[family][0]
    opt = dict(name="AdamW", lr=lr, weight_decay=1e-3,
               global_weight_decay=False, no_weight_decay_layer_name_list=())
    sched = dict(scheduler="CosineLR", lr=lr, epochs=4, min_lr=1e-6)
    with jax_f32():
        shapes = jax.eval_shape(lambda: case[1].init(
            jax.random.PRNGKey(0), jnp.asarray(case[0][0]["image"]), False))
    variables = {"params": random_params(shapes["params"], 1),
                 "batch_stats": random_batch_stats(shapes["batch_stats"], 2)}
    return case, opt, sched, variables


def _run_jax(case, opt, sched, variables):
    """The JAX engine's steps: each step's metrics, the parameters after
    the first step and after the last (flat numpy trees)."""
    batches, jmodel, _, jax_loss_fn, _ = case
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**opt),
        jax_schedule.SchedulerConfig(**sched), 2, variables["params"])
    jcfg = jax_engine.EngineConfig()
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, variables["params"]),
        {"batch_stats": jax.tree.map(jnp.asarray,
                                     variables["batch_stats"])}, tx, jcfg)
    metrics, params = [], []
    with jax_f32():
        jstep = jax_engine.make_train_step(jax_loss_fn, tx, jcfg,
                                           donate=False)
        for batch in batches:
            jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                               jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in jm.items()})
            params.append(flatten_tree(jax.tree.map(np.asarray,
                                                    jstate.params)))
    assert int(jstate.step) == STEPS
    return metrics, params[0], params[-1]


def _run_port(case, opt, sched, variables):
    """The port's engine on the CPU, as ``_run_jax``."""
    batches, _, model, _, port_loss_fn = case
    load_jax_params(model, variables["params"],
                    batch_stats=variables["batch_stats"])
    popt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**sched), 2, model, device="cpu")
    state = port_engine.create_train_state(model, popt,
                                           port_engine.EngineConfig(),
                                           device="cpu")
    step = port_engine.make_train_step(port_loss_fn,
                                       port_engine.EngineConfig())
    metrics, params = [], []
    with torch.backends.mkldnn.flags(enabled=False):
        for batch in batches:
            state, pm = step(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in pm.items()})
            # export shares the parameters' storage: copy before the next
            # step moves them
            params.append({k: v.copy() for k, v in
                           flatten_tree(export_jax_params(model)).items()})
    assert state.step == STEPS
    return metrics, params[0], params[-1]


def _gaps(got, want, start):
    """Each step's largest relative gap over the reported losses, and the
    final change's relative L2 gap and cosine."""
    (gm, _, gp), (wm, _, wp) = got, want
    assert set(gp) == set(wp) == set(start)
    steps = [max(abs(g[k] - w[k]) / abs(w[k]) for k in w if k != "skipped")
             for g, w in zip(gm, wm)]
    dg = np.concatenate([(gp[p] - start[p]).ravel() for p in sorted(wp)])
    dw = np.concatenate([(wp[p] - start[p]).ravel() for p in sorted(wp)])
    return (steps, np.linalg.norm(dg - dw) / np.linalg.norm(dw),
            np.dot(dg, dw) / (np.linalg.norm(dg) * np.linalg.norm(dw)))


@pytest.mark.parametrize("family", ["detection", "recognition"])
def test_three_engine_steps_track_jax(family, jax_detection_loss):
    case, opt, sched, variables = _case(family, jax_detection_loss)
    want = _run_jax(case, opt, sched, variables)
    got = _run_port(case, opt, sched, variables)
    for g, w in zip(got[0], want[0]):
        assert g["skipped"] == w["skipped"] == 0.0
    assert_updates_agree(got[1], want[1], variables["params"], opt)
    steps, l2, cos = _gaps(got, want, flatten_tree(variables["params"]))
    _, loss_rel, l2_rel, least_cos = TRACK[family]
    assert steps[0] <= 1e-5, steps
    assert steps[1] <= loss_rel[0] and steps[2] <= loss_rel[1], steps
    assert l2 <= l2_rel and cos > least_cos, (l2, cos)


def _readings():
    """Prints the readings that ``TRACK``'s bounds are set from: the port
    against JAX, and JAX against itself with every starting weight moved
    by 1 ulp (``python tests/test_torch_ocr_cli.py``, from the repo)."""
    for family in TRACK:
        case, opt, sched, variables = _case(family, _jax_detection_loss())
        start = flatten_tree(variables["params"])
        nudged = jax.tree.map(
            lambda a: np.nextafter(a, np.float32(np.inf)), variables)
        want = _run_jax(case, opt, sched, variables)
        for name, got in (
                ("port", _run_port(case, opt, sched, variables)),
                ("JAX + 1 ulp", _run_jax(case, opt, sched, nudged))):
            steps, l2, cos = _gaps(got, want, start)
            print(f"{family} lr {opt['lr']:g} {name}: loss gaps "
                  f"{', '.join(f'{x:.3g}' for x in steps)}; "
                  f"final change L2 {l2:.4g}, cosine {cos:.6g}")


if __name__ == "__main__":
    with one_torch_thread():
        _readings()
