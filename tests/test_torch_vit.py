"""The port's ViT backbone against the JAX package's on the same seeded
weights, in f32 on the CPU: logits and parameter gradients for each of the
three attention paths and both heads, gradient checkpointing, DropPath, the
parameter bridge in both directions, and the registered variants."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.losses.classification import CELoss as JaxCELoss
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.losses.classification import CELoss
from simpleaicv_tpu_torch.models.backbones.vit import ViT
from simpleaicv_tpu_torch.models.common import DropPath, dropout

from _torch_port import flatten_tree, jax_f32, random_params

# 32^2 images in 8^2 patches: 17 tokens, which no attention block divides
TINY = dict(patch_size=8, embedding_planes=64, block_nums=2, head_nums=2,
            image_size=32, num_classes=10)
ATTENTION = {"einsum": {}, "flash": {"use_flash_attention": True},
             "recompute": {"use_recompute_attention": True}}


def _batch(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, (n,)).astype(np.int32))


def _pair(seed=1, **options):
    """(JAX model, its seeded params, the port's model loaded with them)."""
    with jax_f32():
        jm = JaxViT(**TINY, **options)
        tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)))["params"]
    params = random_params(tree, seed=seed)
    tm = ViT(**TINY, dtype=torch.float32, **options)
    load_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("global_pool", [False, True])
@pytest.mark.parametrize("attention", sorted(ATTENTION))
def test_vit_logits_match_jax(attention, global_pool):
    jm, params, tm = _pair(global_pool=global_pool, **ATTENTION[attention])
    x, _ = _batch()
    with jax_f32():
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), False))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=1e-5)  # f32, other sum order


@pytest.mark.parametrize("attention", sorted(ATTENTION))
def test_vit_gradients_match_jax(attention):
    """d CELoss / d every parameter, compared in the JAX tree's layout."""
    jm, params, tm = _pair(global_pool=True, **ATTENTION[attention])
    x, y = _batch(seed=2)
    with jax_f32():
        want = jax.grad(lambda p: JaxCELoss()(
            jm.apply({"params": p}, jnp.asarray(x), True,
                     rngs={"dropout": jax.random.PRNGKey(0)}),
            jnp.asarray(y)))(jax.tree.map(jnp.asarray, params))
    loss = CELoss()(tm.train()(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    got = export_jax_params(
        tm, {name: p.grad for name, p in tm.named_parameters()})
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], np.asarray(want[path]),
                                   rtol=1e-4, atol=1e-6, err_msg=path)


def test_gradient_checkpoint_equals_plain():
    _, params, plain = _pair(use_flash_attention=True)
    ckpt = ViT(**TINY, dtype=torch.float32, use_flash_attention=True,
               use_gradient_checkpoint=True)
    ckpt.load_state_dict(plain.state_dict())
    x, y = _batch(seed=3)
    grads = []
    for model in (plain, ckpt):
        loss = CELoss()(model.train()(torch.from_numpy(x)),
                        torch.from_numpy(y))
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_gradient_checkpoint_replays_the_same_masks():
    """With drop-path and dropout on, the recomputation must draw the masks
    the forward drew: gradients equal the un-checkpointed model's under the
    same generator seed, and the generator ends where the forward left it."""
    options = dict(use_recompute_attention=True, dropout_prob=0.2,
                   drop_path_prob=0.3)
    _, params, plain = _pair(**options)
    ckpt = ViT(**TINY, dtype=torch.float32, use_gradient_checkpoint=True,
               **options)
    ckpt.load_state_dict(plain.state_dict())
    x, y = _batch(seed=4, n=8)
    grads, states = [], []
    for model in (plain, ckpt):
        gen = torch.Generator().manual_seed(11)
        loss = CELoss()(model.train()(torch.from_numpy(x), generator=gen),
                        torch.from_numpy(y))
        after_forward = gen.get_state()
        loss.backward()
        assert torch.equal(gen.get_state(), after_forward)
        grads.append([p.grad for p in model.parameters()])
        states.append(after_forward)
    assert torch.equal(*states)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_drop_path_statistics_and_scaling():
    layer = DropPath(0.25).train()
    x = torch.ones(4000, 3, 2)
    y = layer(x, torch.Generator().manual_seed(0))
    per_sample = y[:, 0, 0]
    # one mask value per sample, kept samples scaled by 1 / keep
    assert torch.equal(y, per_sample[:, None, None].expand_as(y))
    assert per_sample.unique().tolist() == pytest.approx([0.0, 1 / 0.75])
    kept = (per_sample > 0).float().mean().item()
    assert abs(kept - 0.75) < 0.03          # 4 sigma of a 4000-sample mean
    assert abs(y.mean().item() - 1.0) < 0.04
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(DropPath(0.0).train()(x), x)
    unscaled = DropPath(0.25, scale_by_keep=False).train()(
        x, torch.Generator().manual_seed(0))
    assert set(unscaled.unique().tolist()) == {0.0, 1.0}


def test_dropout_statistics_and_generator():
    x = torch.ones(200, 100)
    a = dropout(x, 0.4, True, torch.Generator().manual_seed(5))
    b = dropout(x, 0.4, True, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert abs((a > 0).float().mean().item() - 0.6) < 0.02
    assert abs(a.mean().item() - 1.0) < 0.03
    assert dropout(x, 0.4, False) is x and dropout(x, 0.0, True) is x


def test_load_and_export_round_trip():
    _, params, tm = _pair(seed=9)
    back = flatten_tree(export_jax_params(tm))
    want = flatten_tree(params)
    assert sorted(back) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(back[path], want[path])
    # the name map the tests of the optimizer rely on
    paths = jax_paths(tm)
    assert paths["blocks.1.attn.qkv.weight"] == "blocks_1/attn/qkv/kernel"
    assert paths["norm.weight"] == "norm/scale"
    assert paths["cls_token"] == "cls_token"
    assert sorted(paths) == sorted(tm.state_dict())


def test_load_and_export_raise_on_leftover_leaves():
    _, params, tm = _pair(seed=9)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_params(tm, extra)
    missing = {k: v for k, v in params.items() if k != "norm"}
    with pytest.raises(KeyError, match="norm"):
        load_jax_params(tm, missing)
    tensors = dict(tm.state_dict(), stray=torch.zeros(1))
    with pytest.raises(ValueError, match="no port parameter"):
        export_jax_params(tm, tensors)
    del tensors["stray"], tensors["fc.bias"]
    with pytest.raises(KeyError, match="fc.bias"):
        export_jax_params(tm, tensors)


VARIANTS = ["vit_base_patch16", "vit_large_patch16", "vit_huge_patch14",
            "vit_small_patch14", "vit_base_patch14", "vit_large_patch14",
            "vit_giant_patch14", "sapiens_0_3b", "sapiens_0_6b",
            "sapiens_1_0b", "sapiens_2_0b"]


@pytest.mark.parametrize("name", VARIANTS)
def test_registered_variant_has_the_jax_parameter_count(name):
    assert name in BACKBONES and name in JAX_BACKBONES
    size = 224 if "patch16" in name or "sapiens" in name else 28
    with torch.device("meta"):
        tm = BACKBONES.create(name, image_size=size, num_classes=1000)
    got = sum(p.numel() for p in tm.parameters())
    jm = JAX_BACKBONES.create(name, image_size=size, num_classes=1000)
    # one block's and the embeddings' shapes, without building 48 blocks
    one = jm.clone(block_nums=1)
    tree = jax.eval_shape(one.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, size, size, 3)))["params"]
    count = {k: sum(int(np.prod(v.shape)) for v in jax.tree.leaves(sub))
             for k, sub in tree.items()}
    block = count.pop("blocks_0")
    assert got == sum(count.values()) + block * jm.block_nums
    # the registry also holds the ResNets, the ViT-MoE backbones
    # (tests/test_torch_moe.py::test_registered_sizes) and the ConvFormer,
    # VAN and DarkNet ones (tests/test_torch_backbone_variants.py); its
    # ViTs are these
    assert sorted(n for n in BACKBONES.names()
                  if not n.startswith(("resnet", "vit_moe_", "convformer_",
                                       "van_", "darknet"))) == sorted(
                      VARIANTS)
