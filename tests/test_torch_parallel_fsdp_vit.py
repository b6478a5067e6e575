"""FSDP2 of a ViT over a ``data 2 x fsdp 2`` mesh of four gloo CPU ranks
against the JAX package's mesh on the 8-device CPU mesh of
``conftest.py``: legs 2 and 3 of
``__graft_entry__.py::_dryrun_multichip_impl``.

2. ViT-S/14 widths (384 wide, 6 heads; depth cut to 2) with AdamW and
   ``infer_param_sharding(min_size=2**8)``: FSDP shards each parameter on
   the JAX rule's dimension; one step's loss to 1e-4 relative and update
   by ``assert_updates_agree``'s AdamW bounds. ``core.optim.global_norm``
   of the sharded gradients is the whole gradient's.
3. The batch over ``data`` and its image rows (H) over ``fsdp`` by
   ``shard_batch``, gathered back over the fsdp group: the same rows, bit
   for bit, and the same loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from _torch_port import (assert_updates_agree, flatten_tree, jax_f32,
                         jax_mesh_steps, one_torch_thread, random_params)
from simpleaicv_tpu.losses.classification import CELoss as JaxCELoss
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT

WORLD = 4
VIT_OPT = dict(name="AdamW", lr=1e-4, weight_decay=0.05)
VIT_SCHED = dict(scheduler="CosineLR", lr=1e-4, epochs=10)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _jax_vit():
    return JaxViT(patch_size=14, embedding_planes=384, block_nums=2,
                  head_nums=6, image_size=28, num_classes=10)


@pytest.fixture(scope="module")
def case(tmp_path_factory, mesh8):
    with jax_f32():
        shapes = jax.eval_shape(lambda: _jax_vit().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3))))
    rng = np.random.RandomState(11)
    vit = {"params": random_params(shapes["params"], seed=3),
           "batch": {"image": rng.randn(8, 28, 28, 3).astype(np.float32),
                     "label": rng.randint(0, 10, (8,)).astype(np.int32)},
           "opt": VIT_OPT, "sched": VIT_SCHED, "fsdp": 2, "min_size": 2**8}
    # the world first, alone: the JAX side after it
    ranks = _torch_dist.run("vit_step", WORLD,
                            tmp_path_factory.mktemp("fsdp_vit_world"), vit)
    with jax_f32():
        jvit = jax_mesh_steps(
            _jax_vit(), JaxCELoss(), {"params": vit["params"]},
            [vit["batch"]], VIT_OPT, VIT_SCHED, {}, mesh8, min_size=2**8)
    return vit, ranks, jvit


class _Fsdp2:
    """A port mesh's ``fsdp`` dim of size 2, for the rule alone."""

    def __getitem__(self, name):
        return self

    def size(self):
        return 2


def test_fsdp_vit_shards_by_the_jax_rule_and_matches(case, mesh8):
    """FSDP shards each parameter on ``infer_param_sharding``'s dim, which
    is the JAX rule's dim of the same weight (the port's Linear keeps [out,
    in], the JAX kernel [in, out], and on a square one each rule takes
    its own first dim, the same size); one step matches the JAX mesh."""
    vit, ranks, (jlosses, jparams, _, _) = case
    from simpleaicv_tpu.parallel.mesh import infer_param_sharding as jrule
    from simpleaicv_tpu_torch.core.weights import jax_paths
    from simpleaicv_tpu_torch.parallel.mesh import infer_param_sharding
    model = _torch_dist._vit_s()
    dims = infer_param_sharding(_Fsdp2(), model, min_size=2**8)
    got = ranks[0]["sharded_dims"]
    assert got == {n: d for n, d in dims.items() if d is not None}
    jspecs = flatten_tree(jax.tree.map(
        lambda s: np.asarray([i for i, a in enumerate(s.spec) if a] or [-1]),
        jrule(mesh8, vit["params"], min_size=2**8),
        is_leaf=lambda s: hasattr(s, "spec")))
    jtree = flatten_tree(vit["params"])
    shapes = dict(model.named_parameters())
    for name, path in jax_paths(model).items():
        jdim = int(jspecs[path][0])
        assert (dims[name] is None) == (jdim < 0), name
        if jdim >= 0:
            assert shapes[name].shape[dims[name]] == jtree[path].shape[jdim]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jlosses[0], rtol=1e-4)
        assert_updates_agree(r["params"], jparams, vit["params"],
                             VIT_OPT)


def test_image_rows_split_over_fsdp_gather_back(case):
    _, ranks, _ = case
    for r in ranks:
        assert r["gathered_equal"]
        assert r["gathered_loss"] == r["row_loss"]


def test_global_norm_of_sharded_gradients_is_the_whole_gradient_s(case):
    """``core.optim.global_norm`` over FSDP2's sharded gradients against
    the f64 norm of the gathered ones: 1e-5 relative (an f32 sum of the
    squares of 2.2e7 elements; 1.9e-6 read on this CPU)."""
    _, ranks, _ = case
    for r in ranks:
        np.testing.assert_allclose(r["norm"], r["norm_whole"],
                                   rtol=1e-5)
