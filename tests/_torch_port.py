"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
f32 compute on the JAX side, seeded numpy parameters for both sides, and
the tiny SAM configuration."""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np

from simpleaicv_tpu.models import common as jax_common

# sam_b at 256^2, 64 wide: the 16x16 token grid pads to 20 for 5x5 windows,
# and the one global layer has n = 256 tokens, so it takes the flash path.
TINY_SAM = dict(image_encoder_embedding_planes=64, image_encoder_block_nums=2,
                image_encoder_head_nums=2, image_encoder_window_size=5,
                image_encoder_global_attn_indexes=(1,),
                prompt_encoder_embedding_planes=64)


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
