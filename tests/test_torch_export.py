"""The hand kernels as ``torch.library`` operators, model export and
tracing, on the CPU.

``torch.library.opcheck`` holds each of the seven operators (K1, K2 with
K3, K4, K5, K6, K7, K7b: schema, fake implementation, autograd
registration, and AOT dispatch with dynamic shapes) on their CPU
implementations, the plain versions. A tiny flash ViT and a tiny DINO-DETR
are exported with ``torch.export`` (``tools/convert_to_export.py``): each
graph calls the ``simpleaicv`` operators, and each program's output is the
eager model's bit for bit and the JAX model's ``apply`` within 1e-4 on the
same weights (f32). The export tool runs its round trip from a work dir;
``core/tracing.py``'s ``StepTimer`` summarises like the JAX one and
``trace`` writes a Chrome trace."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.library import opcheck

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.core.tracing import StepTimer as JaxStepTimer
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT
from simpleaicv_tpu_torch.core import tracing
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params)
from simpleaicv_tpu_torch.models.backbones.vit import ViT
from simpleaicv_tpu_torch.models.common import init_params
from simpleaicv_tpu_torch.ops import flash_attention as fa
from simpleaicv_tpu_torch.ops import msda
from simpleaicv_tpu_torch.tools import convert_to_export as export_tool

from _torch_port import TINY_DINO, jax_f32, one_torch_thread

VIT = dict(patch_size=16, embedding_planes=64, block_nums=2, head_nums=2,
           image_size=64, num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _rand(*shape, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).requires_grad_(grad)


def _op_cases():
    """(name, operator, arguments) of every operator at a small shape; the
    forwards' inputs require gradients, so that autograd is checked."""
    q, k, v = (_rand(1, 2, 24, 8, seed=i, grad=True) for i in range(3))
    o, lse = fa._FLASH_FWD(q.detach(), k.detach(), v.detach())
    bh, n, d = 2, 16, 8
    rq, rk, rv = (_rand(bh, n, d, seed=3 + i, grad=True) for i in range(3))
    rh, rw = _rand(bh, n, 4, seed=6, grad=True), _rand(bh, n, 4, seed=7,
                                                       grad=True)
    ro, rlse = fa._RELPOS_FWD(*(t.detach() for t in (rq, rk, rv, rh, rw)))
    do = _rand(bh, n, d, seed=8)
    relpos_bwd = (*(t.detach() for t in (rq, rk, rv, rh, rw)), do, rlse,
                  (do * ro).sum(-1))
    g = torch.Generator().manual_seed(9)
    shapes = [4, 4, 2, 2]
    value = _rand(1, 20, 2, 4, seed=10, grad=True)
    loc = torch.rand(1, 6, 2, 2, 3, 2, generator=g).requires_grad_()
    wts = torch.rand(1, 6, 2, 2, 3, generator=g).requires_grad_()
    return [
        ("flash_attention_fwd", fa._FLASH_FWD, (q, k, v)),
        ("flash_attention_bwd", fa._FLASH_BWD,
         (q.detach(), k.detach(), v.detach(), o, lse,
          _rand(1, 2, 24, 8, seed=11))),
        ("flash_attention_relpos_fwd", fa._RELPOS_FWD, (rq, rk, rv, rh, rw)),
        ("flash_attention_relpos_dq", fa._RELPOS_DQ, relpos_bwd),
        ("flash_attention_relpos_dkv", fa._RELPOS_DKV, relpos_bwd),
        ("msda_fwd", msda._MSDA_FWD, (value, loc, wts, shapes)),
        ("msda_bwd", msda._MSDA_BWD,
         (value.detach(), loc.detach(), wts.detach(),
          _rand(1, 6, 8, seed=12), shapes)),
    ]


@pytest.mark.parametrize("index", range(7))
def test_opcheck_on_the_cpu(index):
    name, op, args = _op_cases()[index]
    assert str(op) == f"simpleaicv.{name}.default"
    results = opcheck(op, args)
    assert all(r == "SUCCESS" for r in results.values()), results


def test_operators_carry_the_same_gradients_as_the_plain_versions():
    """Autograd through the operators is the plain backward: the flash
    forward's gradients against autograd of the plain forward."""
    q, k, v = (_rand(1, 2, 24, 8, seed=20 + i, grad=True) for i in range(3))
    g = _rand(1, 2, 24, 8, seed=23)
    (fa.flash_attention(q, k, v) * g).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (fa.flash_attention_reference(q, k, v)[0] * g).sum().backward()
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-6)


def _assert_tree_equal(got, want):
    for key, val in want.items():
        if torch.is_tensor(val):
            assert torch.equal(got[key], val), key


def test_flash_vit_exports_with_the_operator_and_matches_jax():
    model = init_params(ViT(**VIT, dtype=torch.float32,
                            use_flash_attention=True),
                        torch.Generator().manual_seed(0)).eval()
    program = export_tool.export_model(model, 64, batch=2, device="cpu")
    assert export_tool.simpleaicv_nodes(program) == \
        ["simpleaicv.flash_attention_fwd.default"] * VIT["block_nums"]
    x = _rand(2, 64, 64, 3, seed=1)
    with torch.no_grad():
        got, want = program.module()(x), model(x)
    assert torch.equal(got, want)
    with jax_f32():
        jax_model = JaxViT(**VIT)
        jax_out = jax.jit(jax_model.apply)(
            {"params": export_jax_params(model)}, jnp.asarray(x.numpy()),
            False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-4,
                               atol=1e-4)


def test_dinodetr_exports_with_the_operator_and_matches_jax():
    model = init_params(MODELS.create("resnet18_dinodetr", **TINY_DINO,
                                      dtype=torch.float32),
                        torch.Generator().manual_seed(0)).eval()
    program = export_tool.export_model(model, 128, batch=1, device="cpu")
    # one call a deformable layer: 1 encoder and 2 decoder layers
    assert export_tool.simpleaicv_nodes(program) == \
        ["simpleaicv.msda_fwd.default"] * 3
    x = _rand(1, 128, 128, 3, seed=2)
    with torch.no_grad():
        got, want = program.module()(x), model(x)
    _assert_tree_equal(got, want)
    with jax_f32():
        jax_model = JAX_MODELS.create("resnet18_dinodetr", **TINY_DINO)
        jax_out = jax.jit(lambda v, x: jax_model.apply(v, x, None, False))(
            {"params": export_jax_params(model),
             "batch_stats": export_jax_batch_stats(model)},
            jnp.asarray(x.numpy()))
    for key in ("pred_logits", "pred_boxes", "aux_pred_logits",
                "aux_pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jax_out[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


TEST_CONFIG = '''from simpleaicv_tpu.models.backbones.vit import ViT


class config:
    input_image_size = 64
    model = ViT(patch_size=16, embedding_planes=64, block_nums=2,
                head_nums=2, image_size=64, num_classes=10,
                use_flash_attention=True, dtype=__import__("torch").float32)
    trained_model_path = {ckpt!r}
    seed = 3
'''


def test_export_tool_round_trip(tmp_path, monkeypatch):
    """The CLI restores ``trained_model_path``, exports, saves; the program
    loads back (the operators registered by ``load_program``) and gives
    the restored model's output."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    trained = init_params(ViT(**VIT, dtype=torch.float32,
                              use_flash_attention=True),
                          torch.Generator().manual_seed(7)).eval()
    ckpt = tmp_path / "best"
    torch.save({"params": trained.state_dict()}, ckpt)
    (tmp_path / "test_config.py").write_text(TEST_CONFIG.format(
        ckpt=str(ckpt)))
    out = tmp_path / "vit.pt2"
    export_tool.main(["--work-dir", str(tmp_path), "--output", str(out),
                      "--batch", "2"])
    program = export_tool.load_program(str(out))
    assert "simpleaicv.flash_attention_fwd.default" in \
        export_tool.simpleaicv_nodes(program)
    x = _rand(2, 64, 64, 3, seed=4)
    with torch.no_grad():
        assert torch.equal(program.module()(x), trained(x))


def test_export_tool_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    (tmp_path / "test_config.py").write_text(TEST_CONFIG.format(ckpt=""))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_tool.main(["--work-dir", str(tmp_path), "--output",
                          str(tmp_path / "m.pt2")])


def test_step_timer_summary_matches_jax(monkeypatch):
    times = [0.9, 0.11, 0.1, 0.13, 0.12, 0.1, 0.4]
    summaries = []
    for cls, module in ((tracing.StepTimer, tracing.time),
                        (JaxStepTimer, None)):
        clock = iter(np.repeat(np.cumsum([0.0] + times), 2)[1:-1])
        fake = type("Clock", (), {"perf_counter": staticmethod(
            lambda: float(next(clock)))})
        if module is None:
            import simpleaicv_tpu.core.tracing as jax_tracing
            monkeypatch.setattr(jax_tracing, "time", fake)
        else:
            monkeypatch.setattr(tracing, "time", fake)
        timer = cls()
        for _ in times:
            timer.start()
            timer.stop(np.zeros(2))
        summaries.append(timer.summary())
    assert summaries[0].keys() == summaries[1].keys() == {
        "mean_s", "p50_s", "p90_s", "steps"}
    for key, val in summaries[1].items():
        assert summaries[0][key] == pytest.approx(val, rel=1e-12), key
    assert summaries[0]["steps"] == len(times) - 1


def test_trace_writes_a_chrome_trace(tmp_path):
    x = _rand(1, 2, 24, 8, seed=5)
    with tracing.trace(str(tmp_path / "trace")):
        fa.flash_attention(x, x, x)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("simpleaicv::flash_attention_fwd" in n for n in names)
    timer = tracing.StepTimer()
    timer.start()
    timer.stop(torch.ones(3))
    timer.start()
    timer.stop()
    assert len(timer.times) == 2 and timer.summary()["steps"] == 1
