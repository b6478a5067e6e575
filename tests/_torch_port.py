"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
f32 compute on the JAX side, seeded numpy parameters and BatchNorm
statistics for both sides, the tiny SAM, DINO-DETR and Sapiens
configurations, a tiny port classifier for the runtime's tests, a
single-thread PyTorch context for files of many small ops, and the check
of a train step's parameter changes against the JAX step's."""

from __future__ import annotations

import contextlib
import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.models import common as jax_common
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.models.backbones.vit import ViT
from simpleaicv_tpu_torch.models.common import ConvBnAct, Linear

# sam_b at 256^2, 64 wide: the 16x16 token grid pads to 20 for 5x5 windows,
# and the one global layer has n = 256 tokens, so it takes the flash path.
TINY_SAM = dict(image_encoder_embedding_planes=64, image_encoder_block_nums=2,
                image_encoder_head_nums=2, image_encoder_window_size=5,
                image_encoder_global_attn_indexes=(1,),
                prompt_encoder_embedding_planes=64)

# resnet18_dinodetr at 128^2 (levels 32^2 to 2^2), 1 encoder and 2 decoder
# layers, hidden 64, 20 queries and 12 denoising slots
TINY_DINO = dict(num_classes=8, query_nums=20, encoder_layer_nums=1,
                 decoder_layer_nums=2, hidden_inplanes=64,
                 feedforward_planes=128, dn_number=6)


# Sapiens' ViT backbone cut to 64 wide, 2 blocks of 2 heads, patch 16; its
# parsing head to (32, 16, 16, 8) and (8, 8, 8, 8) planes
TINY_SAPIENS_BACKBONE = dict(patch_size=16, embedding_planes=64,
                             block_nums=2, head_nums=2, feedforward_ratio=4)
TINY_SAPIENS = dict(backbone_type="tiny_sapiens",
                    deconv_planes=(32, 16, 16, 8), conv_planes=(8, 8, 8, 8))


def register_tiny_sapiens():
    """Registers ``tiny_sapiens`` in both packages' backbone registries
    (once per process)."""
    if "tiny_sapiens" not in BACKBONES:
        BACKBONES.register("tiny_sapiens")(
            lambda **kw: ViT(**TINY_SAPIENS_BACKBONE, **kw))
    if "tiny_sapiens" not in JAX_BACKBONES:
        JAX_BACKBONES.register("tiny_sapiens")(
            lambda **kw: JaxViT(**TINY_SAPIENS_BACKBONE, **kw))


@contextlib.contextmanager
def one_torch_thread():
    """PyTorch's CPU ops on one intra-op thread while the block runs. The
    suite runs its files in parallel processes, several to a core: there
    a thread pool per process spins against the others' (a CLI test file
    took 657 s in six copies at once with the default pool, 21 s with one
    thread), while alone one thread costs these tiny models little."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(previous)


@contextlib.contextmanager
def jax_f32():
    """Runs the JAX package in f32 compute, restoring its dtype after."""
    previous = jax_common.cdtype()
    jax_common.set_compute_dtype(jnp.float32)
    try:
        yield
    finally:
        jax_common.set_compute_dtype(previous)


def random_params(tree, seed: int):
    """A numpy copy of a flax parameter tree with every leaf drawn from a
    seeded normal: kernels at 1/sqrt(fan_in), LayerNorm scales near 1, and
    every other leaf (biases, embeddings, rel-pos tables, pos_embed)
    non-zero, so the bias paths are exercised."""
    rng = np.random.RandomState(seed)

    def draw(node):
        out = {}
        for key in sorted(node):
            val = node[key]
            if hasattr(val, "items"):
                out[key] = draw(val)
                continue
            shape = tuple(val.shape)
            if key == "kernel":
                std = 1.0 / np.sqrt(np.prod(shape[:-1]))
                arr = rng.randn(*shape) * std
            elif key == "scale":
                arr = 1.0 + 0.1 * rng.randn(*shape)
            elif key in ("positional_encoding_gaussian_matrix",
                         "point_embeddings", "not_a_point_embed",
                         "no_mask_embed", "iou_token", "mask_tokens"):
                arr = rng.randn(*shape)
            else:
                arr = 0.1 * rng.randn(*shape)
            out[key] = arr.astype(np.float32)
        return out

    return draw(tree)


def random_batch_stats(tree, seed: int):
    """A numpy copy of a flax ``batch_stats`` tree: running means near 0
    and running variances in [0.5, 1.5], from a seeded generator."""
    rng = np.random.RandomState(seed)

    def draw(node):
        out = {}
        for key in sorted(node):
            val = node[key]
            if hasattr(val, "items"):
                out[key] = draw(val)
            elif key == "var":
                out[key] = (0.5 + rng.rand(*val.shape)).astype(np.float32)
            else:
                out[key] = (0.1 * rng.randn(*val.shape)).astype(np.float32)
        return out

    return draw(tree)


def flatten_tree(tree, prefix=""):
    """{'a': {'b': x}} -> {'a/b': numpy x}."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(val, "items"):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


class TinyClassifier(nn.Module):
    """conv-BatchNorm-ReLU, a global mean and a linear head in f32 on NHWC
    images: parameters, BatchNorm buffers and the classification task's
    call signature at a fraction of ResNet-18's cost, for the tests of the
    Trainer's and the checkpoints' bookkeeping."""

    def __init__(self, num_classes: int = 4):
        super().__init__()
        self.stem = ConvBnAct(3, 8, 3, 2, dtype=torch.float32)
        self.fc = Linear(8, num_classes)

    def forward(self, x, generator=None):
        return self.fc(self.stem(x, self.training).mean(dim=(1, 2)))


def assert_updates_agree(got, want, start, opt):
    """A train step's parameter changes (nested trees ``got`` and ``want``
    after the step, ``start`` before it) against the JAX step's, for the
    optimizer ``opt`` (an ``OptimizerConfig``'s fields). The train-mode
    gradients part by rounding: train-mode BatchNorm at batch 2 amplifies
    the f32 rounding of its batch statistics, which the two sides sum in
    other orders (as ``tests/test_torch_segmentation_task.py`` found for
    DeepLabV3+). SGD's change is the gradient's: each leaf's within 5% of
    the JAX change in L2, at a cosine above 0.99, and a leaf that JAX
    leaves alone (a level without positives: RetinaFace's last box
    convolution's bias) stays. AdamW's first change is about lr times the
    sign of each gradient element, so where rounding flips a sign near 0
    the two sides part by 2 lr: no element by more than 2 lr, at most 0.5%
    of them by more than lr / 10, and the whole change at a cosine above
    0.99 (1 - 2 x 0.5%)."""
    got, want, start = (flatten_tree(jax.tree.map(np.asarray, t))
                        for t in (got, want, start))
    assert set(got) == set(want) == set(start)
    lr, far, total = opt["lr"], 0, 0
    flat_g, flat_w = [], []
    for path, w in want.items():
        dw, dg = w - start[path], got[path] - start[path]
        if opt["name"] == "SGD":
            norm = np.linalg.norm(dw)
            if norm == 0:
                assert not dg.any(), path
                continue
            assert np.linalg.norm(dg - dw) <= 0.05 * norm, path
            cos = np.dot(dg.ravel(), dw.ravel()) / (np.linalg.norm(dg) * norm)
            assert cos > 0.99, (path, cos)
        else:
            diff = np.abs(dg - dw)
            assert diff.max() <= 2 * lr * (1 + 1e-2), (path, diff.max())
            far += int((diff > 0.1 * lr).sum())
            total += diff.size
            flat_g.append(dg.ravel())
            flat_w.append(dw.ravel())
    if opt["name"] != "SGD":
        assert far <= 0.005 * total, (far, total)
        dg, dw = np.concatenate(flat_g), np.concatenate(flat_w)
        cos = np.dot(dg, dw) / (np.linalg.norm(dg) * np.linalg.norm(dw))
        assert cos > 0.99, cos


def load_jax_demo(name: str):
    """The JAX package's ``demo/<name>.py`` as a module of its own (the
    ``demo`` folder is no package)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "demo", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_demo_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def skip_jax_init(module):
    """While the block runs, the functions that ``module`` (the JAX
    ``demo/predictors.py``) jits return None instead of compiling and
    running: a predictor built in the block has ``variables`` None, for
    seeded weights to take their place, and compiles no ``init``. The
    forward functions it jits compile at their first call after the
    block."""
    real = module.jax
    building = [True]

    class _SkipInitJax:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def jit(fn, **kwargs):
            compiled = real.jit(fn, **kwargs)

            def call(*args):
                return None if building[0] else compiled(*args)
            return call

    module.jax = _SkipInitJax()
    try:
        yield
    finally:
        building[0] = False
        module.jax = real


def zero_fill(model, generator=None):
    """A stand-in for the port's ``init_params`` where every weight is
    loaded after (a zero fill costs nothing beside the truncated normal's
    draw)."""
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    return model


def jax_variables(params, stats):
    """A flax variables dict of numpy ``params`` and ``batch_stats`` (or
    None)."""
    variables = {"params": jax.tree.map(jnp.asarray, params)}
    if stats is not None:
        variables["batch_stats"] = jax.tree.map(jnp.asarray, stats)
    return variables


def seed_both(jax_predictor, port_predictor, seed):
    """Draws seeded JAX trees of the port model's layout
    (``export_jax_params``: no JAX ``init`` is traced), loads them into
    the port predictor's model and sets them as the JAX predictor's
    variables; returns (params, batch_stats or None)."""
    from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                                   export_jax_params,
                                                   load_jax_params)
    model = port_predictor.model
    params = random_params(export_jax_params(model), seed)
    stats = export_jax_batch_stats(model)
    stats = random_batch_stats(stats, seed + 1) if stats else None
    load_jax_params(model, params, batch_stats=stats)
    jax_predictor.variables = jax_variables(params, stats)
    return params, stats


def assert_samples_equal(got, want, where=""):
    """A reader's sample against the JAX reader's: the same keys, and each
    value equal, arrays in dtype, shape and every element."""
    assert list(got) == list(want), (where, list(got), list(want))
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, (list, tuple)):
            assert isinstance(a, (list, tuple)) and len(a) == len(b), (
                where, key)
            for i, (x, y) in enumerate(zip(a, b)):
                assert_values_equal(x, y, f"{where} {key}[{i}]")
        else:
            assert_values_equal(a, b, f"{where} {key}")


def assert_values_equal(a, b, where=""):
    if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def jax_mesh_steps(model, criterion, variables, batches, opt, sched, engine,
                   mesh, min_size=None, steps_per_epoch=10):
    """The JAX engine's steps of ``model`` (a flax module) with
    ``criterion`` on ``mesh``: the batch sharded over every mesh axis and,
    with ``min_size``, the parameters by ``infer_param_sharding``.
    ``variables`` holds numpy ``params`` and maybe ``batch_stats``;
    ``opt``, ``sched`` and ``engine`` are the configs' fields. Returns the
    losses and numpy copies of the parameters, the batch statistics (or
    None) and the EMA parameters (or None), in f32 compute."""
    from simpleaicv_tpu.core import engine as jax_engine
    from simpleaicv_tpu.core import optim as jax_optim
    from simpleaicv_tpu.core import schedule as jax_schedule
    from simpleaicv_tpu.parallel.mesh import (batch_sharding,
                                              infer_param_sharding,
                                              replicated)
    from simpleaicv_tpu.tasks import classification as jax_task

    with jax_f32():
        params = jax.tree.map(jnp.asarray, variables["params"])
        state_vars = {k: jax.tree.map(jnp.asarray, v)
                      for k, v in variables.items() if k != "params"}
        if min_size is not None:
            params = jax.device_put(params, infer_param_sharding(
                mesh, params, min_size=min_size))
        state_vars = jax.device_put(state_vars, replicated(mesh))
        cfg = jax_engine.EngineConfig(**engine)
        tx, _ = jax_optim.build_optimizer(
            jax_optim.OptimizerConfig(**opt),
            jax_schedule.SchedulerConfig(**sched), steps_per_epoch, params)
        state = jax_engine.create_train_state(params, state_vars, tx, cfg)
        step = jax_engine.make_train_step(
            jax_task.make_loss_fn(model, criterion), tx, cfg, mesh=mesh,
            donate=False)
        bsh = batch_sharding(mesh)
        losses = []
        for b in batches:
            state, m = step(state, {k: jax.device_put(np.asarray(v), bsh)
                                    for k, v in b.items()},
                            jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
    tree = lambda t: None if t is None else jax.tree.map(  # noqa: E731
        lambda a: np.array(a), t)
    return (losses, tree(state.params),
            tree(state.state_vars.get("batch_stats")), tree(state.ema_params))


def shared_result(tmp_path_factory, name: str, fn):
    """``fn()`` computed once for every test process of a run and read
    back by the others (pytest-xdist's workers share the parent of their
    base temporary directories): a lock file makes the other processes
    wait for the first one's result. ``name`` names what ``fn`` computes,
    whole: two calls under one name must compute the same thing."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = fn()
        with open(f"{path}.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(f"{path}.tmp", path)
        return out
