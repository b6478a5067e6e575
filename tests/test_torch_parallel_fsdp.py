"""FSDP2 over a ``data 2 x fsdp 2`` mesh of four gloo CPU ranks against the
JAX package's ``('data', 'fsdp')`` mesh on the 8-device CPU mesh of
``conftest.py``: legs 1 and 7 of
``__graft_entry__.py::_dryrun_multichip_impl``, and the Trainer's
checkpoint of a sharded model.

1. ResNet-18 with train-mode BatchNorm, SGD, ``accumulation_steps=2`` and
   EMA, parameters over ``infer_param_sharding(min_size=2**10)``: three
   steps of global batches of 16 at 64^2, held to the JAX mesh's losses
   (1e-4 relative), updates and EMA (``assert_updates_agree``: each leaf
   within 5% in L2 at a cosine above 0.99) and BatchNorm statistics (1e-3
   of each leaf's largest value); see ``test_torch_parallel_dp.py`` for the
   spread these bounds allow.
7. ``PackedLoader`` over four ranks: disjoint shards, each rank's first
   batch its ``rows_of`` the JAX loaders' global batch (the JAX loader's
   processes simulated as ``__graft_entry__`` does), feeding the leg-1 step
   to a finite loss.

The checkpoint: whole tensors written by rank 0, read back into a fresh
sharded model and optimizer bit for bit.
"""

import os

import numpy as np
import pytest

import _torch_dist
from _torch_port import assert_updates_agree, flatten_tree, one_torch_thread
from simpleaicv_tpu.data.packed import PackedLoader as JaxPackedLoader
from simpleaicv_tpu.data.packed import pack_dataset
from simpleaicv_tpu_torch.parallel.mesh import rows_of

import test_torch_parallel_dp as dp

WORLD = 4
N_PACK = 24


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


class _TinyDs:
    def __len__(self):
        return N_PACK

    def __getitem__(self, i):
        r = np.random.RandomState(i)
        return {"image": r.randint(0, 256, (64, 64, 3)).astype(np.float32),
                "label": np.int32(i)}


@pytest.fixture(scope="module")
def case(tmp_path_factory, mesh8):
    resnet = {**dp._resnet_payload(), "fsdp": 2, "min_size": 2**10}
    pack = str(tmp_path_factory.mktemp("pack") / "tiny.pack")
    pack_dataset(_TinyDs(), pack)
    resnet["pack"] = pack
    resnet["ckpt"] = str(tmp_path_factory.mktemp("ckpt"))
    # the world first, alone, as in test_torch_parallel_dp.py
    ranks = _torch_dist.run("resnet_steps", WORLD,
                            tmp_path_factory.mktemp("fsdp_world"), resnet)
    jres = dp.resnet_mesh_steps(tmp_path_factory, mesh8, resnet)
    return resnet, ranks, jres


def test_fsdp_resnet_matches_the_jax_mesh(case):
    resnet, ranks, (jlosses, jparams, jstats, jema) = case
    # FSDP shards the large parameters; the rest stay replicated
    assert any("conv.weight" in n for n in ranks[0]["sharded"])
    assert not any(n.endswith("running_mean")
                   for n in ranks[0]["sharded"])
    want = flatten_tree(jstats)
    for r in ranks:
        got = r
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
        assert_updates_agree(got["params"], jparams, resnet["params"], dp.OPT)
        assert_updates_agree(got["ema"], jema, resnet["params"], dp.OPT)
        for path, g in flatten_tree(got["stats"]).items():
            assert np.abs(g - want[path]).max() <= \
                1e-3 * np.abs(want[path]).max(), path


def test_fsdp_checkpoint_holds_whole_tensors_and_resumes(case):
    """Rank 0 writes whole tensors (gathered on every rank); every rank
    reads them back into a fresh sharded model and optimizer, bit for
    bit: parameters, buffers, moments, EMA and step counts."""
    resnet, ranks, _ = case
    import torch
    saved = torch.load(os.path.join(resnet["ckpt"], "latest", "1.pt"),
                       weights_only=True)
    assert saved["model"]["fc.weight"].shape == (10, 512)
    assert all(type(t) is torch.Tensor for t in saved["model"].values())
    for r in ranks:
        assert r["resume_equal"]


def test_packed_loader_shards_are_disjoint_and_the_jax_rows(case):
    resnet, ranks, _ = case
    shards = [r["pack_indices"] for r in ranks]
    flat = np.concatenate(shards)
    assert len(np.unique(flat)) == len(flat) == N_PACK
    gb = len(resnet["batches"][0]["label"])
    loaders = []
    for pid in range(WORLD):
        ld = JaxPackedLoader(resnet["pack"], gb, shuffle=True, seed=0,
                             prefetch=1)
        ld._pid, ld._nproc = pid, WORLD
        ld.local_batch_size = gb // WORLD
        loaders.append(ld)
    glabels = np.concatenate([next(iter(ld))["label"] for ld in loaders])
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["pack_labels"],
            rows_of(glabels, rank, WORLD, dp.ENGINE["accumulation_steps"]))
        assert np.isfinite(r["pack_loss"])
