"""The port's SAM modules against the JAX package's, in f32 on the CPU, on
the same seeded weights (bridged by ``load_jax_params``) and inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.models.interactive_segmentation import (
    image_encoder as jax_ie, mask_decoder as jax_md, prompt_encoder as jax_pe)
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import load_jax_params
from simpleaicv_tpu_torch.models.common import LayerNorm
from simpleaicv_tpu_torch.models.interactive_segmentation import (
    image_encoder, mask_decoder, prompt_encoder)

from _torch_port import TINY_SAM, jax_f32, random_params

IMG = 256
C = 64


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(t):
    return t.detach().numpy()


def _points(rng, b=2, n=3):
    """[B, N, 3] clicks with one -1 padding slot per row."""
    pts = np.concatenate([rng.rand(b, n, 2) * IMG,
                          rng.randint(0, 2, (b, n, 1))], -1)
    pts[:, -1, 2] = -1
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def tiny_sam():
    """The JAX sam_b at 256^2 with seeded random weights, and the port's
    sam_b filled from them."""
    rng = np.random.RandomState(0)
    jax_model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
    prompts = {"prompt_point": jnp.asarray(_points(rng)),
               "prompt_box": jnp.zeros((2, 4)),
               "prompt_mask": jnp.zeros((2, IMG // 4, IMG // 4, 1))}
    with jax_f32():
        shapes = jax.eval_shape(
            lambda: jax_model.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, IMG, IMG, 3)), prompts))
    params = random_params(shapes["params"], seed=1)
    port = MODELS.create("sam_b", image_size=IMG, dtype=torch.float32,
                         **TINY_SAM)
    load_jax_params(port, params)
    return jax_model, params, port.eval()


def test_load_jax_params_fills_every_parameter(tiny_sam):
    _, params, port = tiny_sam
    sd = port.state_dict()
    # reference SAM key names, with each layout change applied
    np.testing.assert_array_equal(
        sd["image_encoder.blocks.0.attn.qkv.weight"].numpy(),
        params["image_encoder"]["blocks_0"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["image_encoder.patch_embed.proj.weight"].numpy(),
        params["image_encoder"]["patch_embed"]["kernel"].transpose(3, 2, 0,
                                                                   1))
    convt = params["mask_decoder"]["upscale_convt1"]["kernel"]
    np.testing.assert_array_equal(
        sd["mask_decoder.output_upscaling.0.weight"].numpy(),
        convt[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(
        sd["prompt_encoder.point_embeddings"].numpy(),
        params["prompt_encoder"]["point_embeddings"])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves

    fresh = MODELS.create("sam_b", image_size=IMG, dtype=torch.float32,
                          **TINY_SAM)
    extra = {**params, "stray": {"kernel": np.zeros((1, 1), np.float32)}}
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_params(fresh, extra)
    partial = {k: v for k, v in params.items() if k != "mask_decoder"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(fresh, partial)


def test_parity_traps_are_pinned():
    """flax defaults the port must state explicitly: LayerNorm eps 1e-6,
    exact (erf) GELU, and an x-major ("xy") grid for the dense PE."""
    port = MODELS.create("sam_b", image_size=IMG, dtype=torch.float32,
                         **TINY_SAM)
    norms = [m for m in port.modules() if isinstance(m, LayerNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)
    assert not any(isinstance(m, torch.nn.LayerNorm) for m in port.modules())
    gelus = [m for m in port.modules() if isinstance(m, torch.nn.GELU)]
    assert gelus and all(m.approximate == "none" for m in gelus)

    pe = prompt_encoder.PositionEmbeddingRandom(2)
    pe.positional_encoding_gaussian_matrix.copy_(torch.eye(2))
    grid = pe.grid_pe(4)
    # row 0, column 1: x = 1.5/4, y = 0.5/4
    expect = 2 * np.pi * (2 * np.array([1.5 / 4, 0.5 / 4]) - 1)
    np.testing.assert_allclose(grid[0, 1, :2].numpy(), np.sin(expect),
                               atol=1e-6)


@pytest.mark.parametrize("use_flash_attention", [False, True])
def test_image_encoder_matches_jax(tiny_sam, use_flash_attention):
    _, params, _ = tiny_sam
    kw = dict(image_size=IMG, patch_size=16, embedding_planes=C,
              block_nums=2, head_nums=2, out_planes=C, window_size=5,
              global_attn_indexes=(1,),
              use_flash_attention=use_flash_attention)
    x = np.random.RandomState(2).rand(1, IMG, IMG, 3).astype(np.float32)
    with jax_f32():
        want = jax.jit(jax_ie.ViTImageEncoder(**kw).apply)(
            {"params": params["image_encoder"]}, jnp.asarray(x))
    port = image_encoder.ViTImageEncoder(dtype=torch.float32, **kw)
    load_jax_params(port, params["image_encoder"], root="image_encoder")
    with torch.no_grad():
        got = port(_t(x))
    assert got.shape == (1, IMG // 16, IMG // 16, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_window_partition_pads_and_round_trips():
    x = torch.randn(2, 16, 16, 3)
    win, pad_hw = image_encoder.window_partition(x, 5)
    assert pad_hw == (20, 20) and win.shape == (2 * 16, 5, 5, 3)
    want, _ = jax_ie.window_partition(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(win.numpy(), np.asarray(want))
    back = image_encoder.window_unpartition(win, 5, pad_hw, (16, 16))
    torch.testing.assert_close(back, x, atol=0, rtol=0)


@pytest.mark.parametrize("q_size,k_size,length", [(16, 16, 31), (5, 5, 19),
                                                  (8, 8, 7)])
def test_get_rel_pos_matches_jax(q_size, k_size, length):
    """Including the linear resize of a table of the wrong length, up and
    down."""
    table = np.random.RandomState(length).randn(length, 6).astype(np.float32)
    want = jax_ie.get_rel_pos(q_size, k_size, jnp.asarray(table))
    got = image_encoder.get_rel_pos(q_size, k_size, _t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_prompt_encoder_matches_jax(tiny_sam):
    _, params, _ = tiny_sam
    rng = np.random.RandomState(3)
    points = _points(rng)
    boxes = (rng.rand(2, 4) * IMG).astype(np.float32)
    masks = rng.randn(2, IMG // 4, IMG // 4, 1).astype(np.float32)
    jax_enc = jax_pe.PromptEncoder(image_size=IMG, embedding_planes=C)
    port = prompt_encoder.PromptEncoder(image_size=IMG, embedding_planes=C)
    load_jax_params(port, params["prompt_encoder"], root="prompt_encoder")
    v = {"params": params["prompt_encoder"]}
    for kwargs in ({"points": points}, {"points": points, "boxes": boxes},
                   {"boxes": boxes}, {"points": points, "masks": masks}):
        want = jax.jit(jax_enc.apply)(v, **{k: jnp.asarray(a)
                                            for k, a in kwargs.items()})
        with torch.no_grad():
            got = port(**{k: _t(a) for k, a in kwargs.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4,
                                       err_msg=str(sorted(kwargs)))
    want_pe = jax_enc.apply(v, method=jax_pe.PromptEncoder.get_dense_pe)
    np.testing.assert_allclose(_np(port.get_dense_pe()),
                               np.asarray(want_pe), atol=1e-4)


def test_mask_decoder_matches_jax(tiny_sam):
    _, params, _ = tiny_sam
    rng = np.random.RandomState(4)
    g = IMG // 16
    emb = rng.randn(1, g, g, C).astype(np.float32)
    pe = rng.randn(1, g, g, C).astype(np.float32)
    sparse = rng.randn(2, 5, C).astype(np.float32)
    dense = rng.randn(2, g, g, C).astype(np.float32)
    want = jax.jit(lambda p, *a: jax_md.MaskDecoder(inplanes=C).apply(
        {"params": p}, *a, mask_out_idxs=(0, 2)))(
        params["mask_decoder"], *map(jnp.asarray, (emb, pe, sparse, dense)))
    port = mask_decoder.MaskDecoder(inplanes=C)
    load_jax_params(port, params["mask_decoder"], root="mask_decoder")
    with torch.no_grad():
        got = port(*map(_t, (emb, pe, sparse, dense)), mask_out_idxs=(0, 2))
    assert got[0].shape == (2, 2, 4 * g, 4 * g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("modality", ["points", "box_and_mask"])
def test_sam_forward_matches_jax(tiny_sam, modality):
    jax_model, params, port = tiny_sam
    rng = np.random.RandomState(5)
    images = rng.rand(2, IMG, IMG, 3).astype(np.float32)
    prompts = {"prompt_point": None, "prompt_box": None, "prompt_mask": None}
    if modality == "points":
        prompts["prompt_point"] = _points(rng)
    else:
        prompts["prompt_box"] = (rng.rand(2, 4) * IMG).astype(np.float32)
        prompts["prompt_mask"] = rng.randn(2, IMG // 4, IMG // 4,
                                           1).astype(np.float32)
    with jax_f32():
        want = jax.jit(lambda p, x, pr: jax_model.apply(
            {"params": p}, x, pr, (0, 1, 2, 3), False))(
            params, jnp.asarray(images),
            {k: None if a is None else jnp.asarray(a)
             for k, a in prompts.items()})
    with torch.no_grad():
        got = port(_t(images), {k: None if a is None else _t(a)
                                for k, a in prompts.items()})
    assert got[0].shape == (2, 4, IMG, IMG) and got[1].shape == (2, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 12), (20, 30)),
                                          ((20, 30), (8, 7)),
                                          ((9, 9), (9, 16))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    """Half-pixel upscale and antialiased downscale, as jax.image.resize."""
    from simpleaicv_tpu_torch.ops.upsample import resize_bilinear
    x = np.random.RandomState(in_hw[0]).randn(2, *in_hw, 3).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "linear")
    np.testing.assert_allclose(resize_bilinear(_t(x), out_hw).numpy(),
                               np.asarray(want), atol=1e-5)


def test_sam_output_options(tiny_sam):
    """sigmoid_out and binary_mask_out post-process the same masks."""
    _, params, port = tiny_sam
    images = _t(np.random.RandomState(6).rand(1, IMG, IMG, 3))
    prompts = {"prompt_point": _t(_points(np.random.RandomState(7), b=1))}
    with torch.no_grad():
        masks, _ = port(images, prompts)
        for options, expect in (
                ({"sigmoid_out": True}, torch.sigmoid(masks)),
                ({"binary_mask_out": True, "mask_threshold": 0.5},
                 (masks > 0.5).float())):
            other = MODELS.create("sam_b", image_size=IMG,
                                  dtype=torch.float32, **TINY_SAM, **options)
            load_jax_params(other, params)
            torch.testing.assert_close(other(images, prompts)[0], expect)
