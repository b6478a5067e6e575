"""GPipe and the pipelined ViT of the port over four gloo CPU ranks against
the JAX package on the 8-device CPU mesh of ``conftest.py``: leg 4 of
``__graft_entry__.py::_dryrun_multichip_impl`` and
``tests/test_pipeline_vit.py``.

* The 4-stage GPipe train step (one ViT block of width 32 a stage, 4
  microbatches of 2, SGD 0.01, MSE), with and without recomputation,
  against the JAX ``make_pipeline_train_step`` on a ``data 1 x pipe 4``
  mesh: the loss to 1e-5 relative, each stage's parameters after the step
  to 1e-6 absolute.
* ``pipeline_vit`` on a tiny ViT (patch 8, 32 wide, 4 blocks) in eval mode
  against the JAX ViT's plain forward and the port's own: over 4 stages
  with the cls-token head, over 4 stages with the global pool and the
  flash attention path, and over 2 stages with a data dim of 2 (each data
  slice its own rows), to ``tests/test_pipeline_vit.py``'s 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dist
from _torch_port import flatten_tree, jax_f32, one_torch_thread, random_params
from simpleaicv_tpu.models.backbones.vit import (TransformerEncoderLayer,
                                                 ViT as JaxViT)
from simpleaicv_tpu.parallel.pipeline import (make_pipeline_mesh,
                                              make_pipeline_train_step,
                                              stack_stage_params)
from simpleaicv_tpu_torch.core.weights import load_jax_params

WORLD = 4
TINY = dict(patch_size=8, embedding_planes=32, block_nums=4, head_nums=2,
            image_size=32, num_classes=10)
VIT_CASES = [dict(pipe=4, global_pool=False, flash=False),
             dict(pipe=4, global_pool=True, flash=True),
             dict(pipe=2, global_pool=False, flash=False)]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.RandomState(5)
    with jax_f32():
        block = TransformerEncoderLayer(head_nums=2)
        tok0 = jnp.zeros((2, 16, 32), jnp.float32)
        stages = [jax.tree.map(np.asarray, block.init(
            jax.random.PRNGKey(i), tok0, False)["params"]) for i in range(4)]
        vshapes = jax.eval_shape(lambda: JaxViT(**TINY).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))["params"]
    x = rng.randn(8, 16, 32).astype(np.float32)
    y = rng.randn(8, 16, 32).astype(np.float32)
    vparams = random_params(vshapes, seed=6)
    image = rng.randn(8, 32, 32, 3).astype(np.float32)
    # the world first, alone: the JAX side after it, so that its compiles
    # do not hold the ranks back
    ranks = _torch_dist.run(
        "pipeline_world", WORLD, tmp_path_factory.mktemp("pipeline"),
        {"gpipe": {"n_pipe": 4, "stages": stages, "x": x, "y": y},
         "vit": {"cases": VIT_CASES, "params": vparams, "image": image}})

    with jax_f32():
        pmesh = make_pipeline_mesh(4, devices=jax.devices()[:4])
        popt = optax.sgd(0.01)

        def stage_fn(p, h):
            return block.apply({"params": p}, h, False)

        def mse(pred, tgt):
            return jnp.mean((pred - tgt)**2)

        stacked = stack_stage_params(
            [jax.tree.map(jnp.asarray, s) for s in stages], pmesh)
        pstep = make_pipeline_train_step(stage_fn, mse, popt, pmesh,
                                         n_micro=4)
        new, _, jloss = pstep(stacked, popt.init(stacked), jnp.asarray(x),
                              jnp.asarray(y))
        jstages = [jax.tree.map(lambda a: np.asarray(a)[s], new)
                   for s in range(4)]
        jlogits = {gp: np.asarray(jax.jit(
            lambda p, xx: JaxViT(**TINY, global_pool=gp).apply(
                {"params": p}, xx, False))(vparams, image))
            for gp in (False, True)}
    port_logits = {}
    for gp in (False, True):
        model = load_jax_params(_torch_dist._tiny_vit(global_pool=gp),
                                vparams).eval()
        with torch.no_grad():
            port_logits[gp] = model(torch.from_numpy(image)).numpy()
    return (ranks, float(jloss), jstages, jlogits, port_logits)


@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_train_step_matches_jax(case, remat):
    ranks, jloss, jstages, _, _ = case
    seen = set()
    for r in ranks:
        got = r["gpipe"][int(remat)]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        seen.add(got["stage"])
        want = flatten_tree(jstages[got["stage"]])
        for path, g in flatten_tree(got["params"]).items():
            np.testing.assert_allclose(g, want[path], atol=1e-6,
                                       err_msg=path)
    assert seen == {0, 1, 2, 3}


@pytest.mark.parametrize("which", range(len(VIT_CASES)),
                         ids=["pipe4", "pipe4_pool_flash", "data2_pipe2"])
def test_pipelined_vit_matches_the_plain_vit(case, which):
    ranks, _, _, jlogits, port_logits = case
    c = VIT_CASES[which]
    gp = c["global_pool"]
    if c["pipe"] == WORLD:
        # every stage returns the whole batch's logits
        got = [r["vit"][which] for r in ranks]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        got = got[0]
    else:
        # data slice d = ranks 2d, 2d + 1, each slice its own rows
        got = np.concatenate([ranks[0]["vit"][which],
                              ranks[2]["vit"][which]])
        np.testing.assert_array_equal(ranks[1]["vit"][which],
                                      ranks[0]["vit"][which])
    np.testing.assert_allclose(got, jlogits[gp], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, port_logits[gp], rtol=2e-5, atol=2e-5)
