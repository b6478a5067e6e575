"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
f32 compute on the JAX side, seeded numpy parameters and BatchNorm
statistics for both sides, the tiny SAM, DINO-DETR and Sapiens
configurations, a tiny port classifier for the runtime's tests, a
single-thread PyTorch context for files of many small ops, and the check
of a train step's parameter changes against the JAX step's."""

from __future__ import annotations

import contextlib

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
