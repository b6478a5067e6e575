"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
f32 compute on the JAX side, seeded numpy parameters and BatchNorm
statistics for both sides, the tiny SAM and DINO-DETR configurations, a
tiny port classifier for the runtime's tests, and a single-thread PyTorch
context for files of many small ops."""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from simpleaicv_tpu.models import common as jax_common
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
