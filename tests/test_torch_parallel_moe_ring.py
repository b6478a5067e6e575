"""Expert sharding and ring attention of the port over four gloo CPU ranks,
against the JAX package on the 8-device CPU mesh of ``conftest.py``: legs
5 and 6 of ``__graft_entry__.py::_dryrun_multichip_impl``.

5. ViT-MoE (leg 5's: patch 14, 32 wide, 2 blocks, 4 experts, top-2,
   capacity factor 1.25) on a ``data 2 x fsdp 2`` mesh, its expert stacks
   split over ``fsdp`` (``shard_experts``: the kept rows go to their
   experts' owners by ``all_to_all_single``), the routing the global
   batch's (capacity, positions and the auxiliary terms over the 80 tokens
   of all ranks). Held to the JAX mesh with ``expert_param_sharding``: the
   logits to 1e-4, the auxiliary loss to 1e-5 relative, every gradient of
   CE + 0.01 aux (averaged over the ranks as the engine averages) to 1e-4
   of its leaf's largest value, as ``tests/test_torch_moe.py`` holds the
   one-device layer. The images are drawn until every token's three
   largest router probabilities are 1e-3 apart in log space, so no top-k
   choice sits within rounding of a tie.
6. Ring attention over 4 ranks (``ring_attention_local``, K/V rotating by
   ``batch_isend_irecv``) on [2, 3, 32, 8] against the JAX
   ``make_ring_attention`` on an 8-device ``sp`` mesh and against full
   attention, with the gradients of ``tests/test_ring_attention.py``'s
   loss, at its tolerances (values 2e-5 relative and 2e-6 absolute,
   gradients 5e-5 and 5e-6; bf16 inputs 2e-2 of the f32 attention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_dist
from _torch_port import flatten_tree, jax_f32, one_torch_thread
from simpleaicv_tpu.models.backbones.vit_moe import ViTMoE as JaxViTMoE
from simpleaicv_tpu.parallel import moe as jax_moe
from simpleaicv_tpu.parallel.mesh import batch_sharding, replicated
from simpleaicv_tpu.parallel.ring_attention import make_ring_attention
from simpleaicv_tpu_torch.core.weights import load_jax_params
from simpleaicv_tpu_torch.parallel import moe

WORLD = 4
B, H, N, D = 2, 3, 32, 8


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _jax_moe():
    return JaxViTMoE(patch_size=14, embedding_planes=32, block_nums=2,
                     head_nums=2, image_size=28, num_classes=10,
                     num_experts=4)


def _moe_params(seed):
    with jax_f32():
        tree = jax.eval_shape(lambda: _jax_moe().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))))["params"]
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in flatten_tree(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), tree)).items():
        name = path.split("/")[-1]
        if name == "kernel":
            arr = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("wi", "wo"):
            arr = rng.randn(*leaf.shape) / np.sqrt(leaf.shape[1])
        elif name == "router":
            arr = 0.5 * rng.randn(*leaf.shape)
        elif name == "scale":
            arr = 1.0 + 0.1 * rng.randn(*leaf.shape)
        else:
            arr = 0.1 * rng.randn(*leaf.shape)
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = arr.astype(np.float32)
    return out


def _margin(probs):
    top = np.log(np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
                 [:, :3])
    return float(np.diff(-top, axis=-1).min())


def _clear_images(params, n=16):
    """Images whose every MoE layer's router has clear top-3 margins."""
    model = load_jax_params(_torch_dist._vit_moe(), params).train()
    for s in range(200):
        image = np.random.RandomState(s).randn(n, 28, 28, 3).astype(
            np.float32)
        seen = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.append(torch.softmax(
                args[0].reshape(-1, args[0].shape[-1]).float() @ mod.router,
                -1).detach().numpy()))
            for m in model.modules() if isinstance(m, moe.MoEFeedForward)]
        with torch.no_grad():
            model(torch.from_numpy(image))
        for h in hooks:
            h.remove()
        if min(_margin(p) for p in seen) > 1e-3:
            return image
    raise AssertionError("no batch with clear router margins")


def _full_attention(q, k, v):
    scores = jnp.einsum("bhnd,bhmd->bhnm", q, k) * (D**-0.5)
    return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(scores, -1), v)


@pytest.fixture(scope="module")
def case(tmp_path_factory, mesh8):
    params = _moe_params(0)
    image = _clear_images(params)
    label = (np.arange(len(image)) % 10).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    qkv = [np.asarray(jax.random.normal(k, (B, H, N, D), jnp.float32))
           for k in keys]
    dout = np.cos(np.arange(B * H * N * D)).reshape(B, H, N, D).astype(
        np.float32)
    cases = [dict(zip("qkv", qkv), dout=dout, dtype=dtype)
             for dtype in ("float32", "bfloat16")]
    # the world first, alone: the JAX side after it, so that its compiles
    # do not hold the ranks back
    ranks = _torch_dist.run(
        "moe_ring_world", WORLD, tmp_path_factory.mktemp("moe_ring"),
        {"moe": {"params": params, "image": image, "label": label},
         "ring": {"cases": cases}})

    jm = _jax_moe()
    msh = jax_moe.expert_param_sharding(
        mesh8, params, axis="fsdp", fallback=lambda v: replicated(mesh8))

    def loss(p, x, y):
        logits, muts = jm.apply({"params": p}, x, True,
                                mutable=["moe_losses"])
        aux = jax_moe.moe_aux_loss(muts)
        ce = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits)
                               * jax.nn.one_hot(y, 10), axis=-1))
        return ce + 0.01 * aux, (logits, aux)

    bsh = batch_sharding(mesh8)
    with jax_f32():
        (_, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(jax.device_put(params, msh),
                                 jax.device_put(image, bsh),
                                 jax.device_put(label, bsh))
    assert jgrads["blocks_1"]["moe_mlp"]["wi"].sharding.spec[0] == "fsdp"

    rmesh = Mesh(np.asarray(jax.devices()), ("sp",))
    ring = jax.jit(make_ring_attention(rmesh, axis="sp", data_axis=None))
    rsh = NamedSharding(rmesh, P(None, None, "sp", None))

    def ring_loss(q, k, v):
        return jnp.sum(ring(q, k, v) * jnp.asarray(dout))

    jring = []
    for c in cases:
        ins = [jax.device_put(jnp.asarray(c[n]).astype(c["dtype"]), rsh)
               for n in "qkv"]
        jring.append((np.asarray(ring(*ins), np.float32),
                      [np.asarray(g, np.float32) for g in
                       jax.jit(jax.grad(ring_loss, argnums=(0, 1, 2)))(
                           *ins)]))
    full = np.asarray(_full_attention(*map(jnp.asarray, qkv)))
    gfull = [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(_full_attention(q, k, v) * dout),
        argnums=(0, 1, 2))(*map(jnp.asarray, qkv))]
    return (params, ranks, (np.asarray(jlogits), float(jaux),
                                     flatten_tree(jgrads)),
            jring, (full, gfull))


def _whole_grads(ranks):
    """The ranks' averaged gradients as whole leaves: an expert slice's
    from the ranks of data slice 0 in expert order."""
    out = {}
    shards = [r["moe"] for r in ranks[:2]]
    for name, g in ranks[0]["moe"]["grads"].items():
        if name.rsplit(".", 1)[-1] not in ("wi", "bi", "wo", "bo"):
            out[name] = g
            continue
        parts = sorted(shards, key=lambda s: s["expert_part"])
        out[name] = np.concatenate([s["grads"][name] for s in parts])
    return out


def test_moe_experts_are_sharded_and_replicas_agree(case):
    _, ranks, _, _, _ = case
    shapes = ranks[0]["moe"]["expert_shapes"]
    assert shapes["blocks.1.moe_mlp.wi"][0] == 2  # 4 experts over fsdp 2
    assert shapes["blocks.1.moe_mlp.router"] == (32, 4)
    # ranks d * 2 + f and (1 - d) * 2 + f hold the same experts and the
    # same averaged gradients; every rank the same replicated ones
    for a, b in ((0, 2), (1, 3)):
        for name, g in ranks[a]["moe"]["grads"].items():
            np.testing.assert_array_equal(g, ranks[b]["moe"]["grads"][name],
                                          err_msg=name)


def test_moe_logits_aux_and_gradients_match_the_jax_mesh(case):
    params, ranks, (jlogits, jaux, jgrads), _, _ = case
    logits = np.concatenate([r["moe"]["logits"] for r in ranks])
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)
    for r in ranks:
        np.testing.assert_allclose(r["moe"]["aux"], jaux, rtol=1e-5)
    model = load_jax_params(_torch_dist._vit_moe(), params)
    from simpleaicv_tpu_torch.core.weights import export_jax_params
    grads = flatten_tree(export_jax_params(model, {
        n: torch.from_numpy(g) for n, g in _whole_grads(ranks).items()}))
    for path, want in jgrads.items():
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(grads[path] - want).max() <= 1e-4 * scale + 1e-7, path
    assert np.abs(grads["blocks_1/moe_mlp/router"]).sum() > 0


@pytest.mark.parametrize("which", [0, 1], ids=["f32", "bf16"])
def test_ring_attention_matches_jax_and_full_attention(case, which):
    _, ranks, _, jring, (full, gfull) = case
    got = np.concatenate([r["ring"][which]["out"] for r in ranks], axis=2)
    grads = [np.concatenate([r["ring"][which]["grads"][i] for r in ranks],
                            axis=2) for i in range(3)]
    jout, jgrads = jring[which]
    if which == 0:
        np.testing.assert_allclose(got, full, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got, jout, rtol=2e-5, atol=2e-6)
        for g, gf, gj in zip(grads, gfull, jgrads):
            np.testing.assert_allclose(g, gf, rtol=5e-5, atol=5e-6)
            np.testing.assert_allclose(g, gj, rtol=5e-5, atol=5e-6)
    else:
        np.testing.assert_allclose(got, full, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got, jout, rtol=2e-2, atol=2e-2)
        for g, gj in zip(grads, jgrads):
            assert np.isfinite(g).all()
            scale = np.abs(gj).max()
            assert np.abs(g - gj).max() <= 5e-2 * scale
