"""Data parallelism of the port over ``torch.distributed`` (gloo, two CPU
ranks) against the JAX package's ``('data', 'fsdp')`` mesh on the 8-device
CPU mesh of ``conftest.py``: the first leg of
``__graft_entry__.py::_dryrun_multichip_impl``, ResNet-18 with train-mode
BatchNorm, SGD, ``accumulation_steps=2`` and EMA, three steps of global
batches of 16 at 64^2; the same with device augmentation (AutoAugment and
mixup/cutmix); and the FCOS loss, whose terms divide by the positives of
the global batch, at two ranks against one.

Each rank takes its rows of every global batch (``parallel.mesh.rows_of``:
its micro-batch i is its slice of global micro-batch i), its BatchNorm
statistics are the global micro-batch's, and the engine averages the
gradients over the ranks: the world's step is the JAX mesh's step.
Tolerances: the losses to 1e-4 relative of JAX's and 1e-5 of the port's
world of one; the parameter and EMA updates by
``_torch_port.assert_updates_agree`` (each leaf within 5% in L2 at a
cosine above 0.99) against JAX and against the world of one; the running
statistics to 1e-3 of each leaf's largest value. Train-mode BatchNorm
amplifies the rounding of other summation orders: the world of two parts
from the world of one and from the mesh by up to 1.9% of a leaf's update
and 2.3e-4 of a statistic's scale, the JAX package's own steps on one
device from its mesh's by 1.5% and 8.8e-5 (``python
tests/test_torch_parallel_dp.py`` prints these readings, with the repo
and ``tests/`` on ``PYTHONPATH``). The size and the rate keep the three
steps out of the chaotic regime of train-mode BatchNorm over a few values
a channel: at 32^2 and lr 0.1 (8 values a channel in layer 4 at batch
16) the JAX package's own two runs part by 64% of an update.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from _torch_port import (flatten_tree, jax_f32, jax_mesh_steps,
                         assert_updates_agree, one_torch_thread,
                         random_batch_stats, random_params, shared_result)
from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.losses.classification import CELoss as JaxCELoss
from simpleaicv_tpu_torch.data import loader as port_loader
from simpleaicv_tpu_torch.data.loader import DataLoader, rank_indices
from simpleaicv_tpu_torch.parallel.mesh import rows_of

WORLD = 2
OPT = dict(name="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4)
SCHED = dict(scheduler="CosineLR", lr=0.01, epochs=10)
ENGINE = dict(accumulation_steps=2, use_ema=True, ema_decay=0.9)
STRIDES, IMG = (8, 16, 32, 64, 128), 128


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _resnet_payload():
    with jax_f32():
        model = JAX_BACKBONES.create("resnet18", num_classes=10)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), False))
    rng = np.random.RandomState(7)
    batches = [{"image": rng.randn(16, 64, 64, 3).astype(np.float32),
                "label": rng.randint(0, 10, (16,)).astype(np.int32)}
               for _ in range(3)]
    return {"params": random_params(shapes["params"], seed=0),
            "stats": random_batch_stats(shapes["batch_stats"], seed=1),
            "batches": batches, "opt": OPT, "sched": SCHED,
            "engine": ENGINE}


def _fcos_payload():
    rng = np.random.RandomState(0)
    b, nc = 4, 6
    sizes = [IMG // s for s in STRIDES]
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)  # noqa: E731
    annots = np.full((b, 5, 5), -1.0, np.float32)
    annots[0, 0] = [8, 8, 70, 70, 2]
    annots[0, 1] = [20, 30, 110, 126, 4]
    annots[1, 0] = [4, 4, 40, 48, 1]
    # images 2 and 3, rank 1's, hold no box: its terms still divide by
    # the global batch's positives
    return {"cls": [sig(rng.randn(b, s, s, nc)) for s in sizes],
            "reg": [rng.randn(b, s, s, 4).astype(np.float32) for s in sizes],
            "center": [sig(rng.randn(b, s, s, 1)) for s in sizes],
            "annotations": annots}


def resnet_mesh_steps(tmp_path_factory, mesh8, resnet):
    """The JAX mesh's (data 4 x fsdp 2) three steps of ``_resnet_payload``,
    computed once for this file and ``test_torch_parallel_fsdp.py``."""

    def steps():
        with jax_f32():
            return jax_mesh_steps(
                JAX_BACKBONES.create("resnet18", num_classes=10), JaxCELoss(),
                {"params": resnet["params"], "batch_stats": resnet["stats"]},
                resnet["batches"], OPT, SCHED, ENGINE, mesh8, min_size=2**10)

    return shared_result(tmp_path_factory, "resnet18_mesh_steps", steps)


@pytest.fixture(scope="module")
def case(tmp_path_factory, mesh8):
    resnet = _resnet_payload()
    rng = np.random.RandomState(8)
    augment_batches = [{
        "image": rng.randint(0, 256, (8, 32, 32, 3)).astype(np.float32),
        "label": rng.randint(0, 10, (8,)).astype(np.int32)}]
    payload = {"resnet": resnet, "augment_batches": augment_batches,
               "fcos": _fcos_payload()}
    # the world first, alone: the JAX side after it, so that its compiles
    # and the spinning threads of its 8 devices do not hold the ranks back
    ranks = _torch_dist.run("dp_world", WORLD,
                            tmp_path_factory.mktemp("dp_world"), payload)
    # the port without a process group: its world of one
    single = {"resnet": _torch_dist.resnet_steps(resnet),
              "fcos": _torch_dist.fcos_loss(payload["fcos"])}
    want = resnet_mesh_steps(tmp_path_factory, mesh8, resnet)
    return payload, ranks, single, want


def test_losses_match_the_jax_mesh_and_the_world_of_one(case):
    _, ranks, single, (jlosses, *_) = case
    for r in ranks:
        np.testing.assert_allclose(r["resnet"]["losses"], jlosses, rtol=1e-4)
        np.testing.assert_allclose(r["resnet"]["losses"],
                                   single["resnet"]["losses"], rtol=1e-5)


def test_parameters_and_ema_match_the_jax_mesh(case):
    payload, ranks, single, (_, jparams, _, jema) = case
    start = payload["resnet"]["params"]
    got = ranks[0]["resnet"]
    assert_updates_agree(got["params"], jparams, start, OPT)
    assert_updates_agree(got["ema"], jema, start, OPT)
    assert_updates_agree(got["params"], single["resnet"]["params"], start,
                         OPT)


def test_batch_statistics_are_the_global_batch_s(case):
    _, ranks, single, (_, _, jstats, _) = case
    want, one = flatten_tree(jstats), flatten_tree(single["resnet"]["stats"])
    for r in ranks:
        for path, g in flatten_tree(r["resnet"]["stats"]).items():
            for ref in (want[path], one[path]):
                assert np.abs(g - ref).max() <= 1e-3 * np.abs(ref).max(), \
                    path


def test_replicas_hold_the_same_weights(case):
    _, ranks, _, _ = case
    for key in ("resnet", "augment"):
        a, b = (flatten_tree(r[key]["params"]) for r in ranks)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)
        a, b = (flatten_tree(r[key]["stats"]) for r in ranks)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)


def test_device_augmentation_step_is_finite(case):
    _, ranks, _, _ = case
    for r in ranks:
        assert np.isfinite(r["augment"]["losses"]).all()
        for path, v in flatten_tree(r["augment"]["params"]).items():
            assert np.isfinite(v).all(), path


def test_count_normalised_loss_at_two_ranks_equals_one(case):
    """FCOS divides each term by the global batch's positives; rank 1's
    images hold none. The mean of the ranks' terms is the world of one's
    term, and each rank's gradient (the engine's share, 1 / 2) its rows of
    the world of one's."""
    _, ranks, single, _ = case
    one = single["fcos"]
    for key, want in one["terms"].items():
        got = np.mean([r["fcos"]["terms"][key] for r in ranks])
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
    assert ranks[1]["fcos"]["terms"]["cls_loss"] > 0
    for r in ranks:
        for g, w in zip(r["fcos"]["grads"], one["grads"]):
            np.testing.assert_allclose(g, w[r["fcos"]["rows"]], rtol=1e-5,
                                       atol=1e-7)


def test_a_non_finite_value_on_one_rank_skips_every_rank(case):
    """The engine agrees its skip over the ranks (one collective with the
    metrics): only the last rank's rows hold an inf, and both ranks skip
    and keep their weights."""
    _, ranks, _, _ = case
    assert [r["skip"]["bad_rows_here"] for r in ranks] == [False, True]
    for r in ranks:
        assert r["skip"]["skipped"] == 1.0 and r["skip"]["kept"]


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_loader_rows_are_the_jax_global_batch_s(monkeypatch, accum):
    """With 4 ranks, each rank's batch b is ``rows_of`` the JAX loader's
    global batch b (its processes' contiguous shards one after the other):
    with one micro-batch the JAX process's own rows, and the ranks
    together read each global batch once."""
    n, world, gb = 70, 4, 16
    lb = gb // world
    order = np.random.RandomState(0 + 3).permutation(n)
    per = n // world
    jax_shards = [order[p * per:(p + 1) * per] for p in range(world)]
    ds = list(range(n))
    for r in range(world):
        monkeypatch.setattr(port_loader, "process_index", lambda: r)
        monkeypatch.setattr(port_loader, "process_count", lambda: world)
        loader = DataLoader(ds, gb, None, shuffle=True, seed=0,
                            accumulation_steps=accum)
        loader.set_epoch(3)
        got = loader._local_indices()
        assert len(got) == per and len(loader) == per // lb
        for b in range(len(loader)):
            glob = np.concatenate([s[b * lb:(b + 1) * lb]
                                   for s in jax_shards])
            np.testing.assert_array_equal(got[b * lb:(b + 1) * lb],
                                          rows_of(glob, r, world, accum))
        if accum == 1:
            np.testing.assert_array_equal(got, jax_shards[r])
        np.testing.assert_array_equal(got[len(loader) * lb:],
                                      jax_shards[r][len(loader) * lb:])
    np.testing.assert_array_equal(rank_indices(order, 0, 1, gb, accum),
                                  order)


def test_world_limit_kills_a_hung_world(tmp_path):
    """A world that outlasts its limit is killed and raises."""
    from simpleaicv_tpu_torch.parallel.multihost import run_world
    with pytest.raises(TimeoutError):
        run_world("time:sleep", 2, str(tmp_path), (30,), backend="gloo",
                  timeout=3.0)
    assert os.path.exists(tmp_path / "rank0.log")


def _spreads():
    """Prints the readings behind this file's bounds: the largest
    per-leaf relative L2 difference of three steps' updates and of the
    running statistics (to each leaf's largest value), the JAX package on
    one device against its 8-device mesh, and the port's world of two
    against its world of one and the mesh; then the same JAX pair at
    32^2, batch 16, lr 0.1, where the steps are chaotic."""
    import tempfile
    from simpleaicv_tpu.parallel import MeshConfig, make_mesh

    def upd(a, b, start):
        a, b, start = (flatten_tree(t) for t in (a, b, start))
        return max(float(np.linalg.norm((a[k] - start[k]) - (b[k] - start[k]))
                         / max(np.linalg.norm(b[k] - start[k]), 1e-12))
                   for k in b)

    def stats(a, b):
        a, b = flatten_tree(a), flatten_tree(b)
        return max(float(np.abs(a[k] - b[k]).max()
                         / max(np.abs(b[k]).max(), 1e-6)) for k in b)

    mesh8 = make_mesh(MeshConfig(data=4, fsdp=2))
    mesh1 = make_mesh(MeshConfig(data=1, fsdp=1), devices=jax.devices()[:1])
    for hw, lr, world in ((64, 0.01, True), (32, 0.1, False)):
        p = _resnet_payload()
        rng = np.random.RandomState(7)
        p["batches"] = [{"image": rng.randn(16, hw, hw, 3).astype(np.float32),
                         "label": rng.randint(0, 10, (16,)).astype(np.int32)}
                        for _ in range(3)]
        p["opt"], p["sched"] = dict(OPT, lr=lr), dict(SCHED, lr=lr)
        js = []
        for mesh in (mesh8, mesh1):
            with jax_f32():
                js.append(jax_mesh_steps(
                    JAX_BACKBONES.create("resnet18", num_classes=10),
                    JaxCELoss(), {"params": p["params"],
                                  "batch_stats": p["stats"]},
                    p["batches"], p["opt"], p["sched"], ENGINE, mesh))
        print(f"{hw}^2 lr {lr}: JAX one device against the mesh: updates "
              f"{upd(js[1][1], js[0][1], p['params']):.3g}, statistics "
              f"{stats(js[1][2], js[0][2]):.3g}")
        if world:
            one = _torch_dist.resnet_steps(p)
            two = _torch_dist.run("resnet_steps", WORLD, tempfile.mkdtemp(),
                                  p)[0]
            print(f"  port world 2 against world 1: updates "
                  f"{upd(two['params'], one['params'], p['params']):.3g}, "
                  f"statistics {stats(two['stats'], one['stats']):.3g}; "
                  f"against the mesh: updates "
                  f"{upd(two['params'], js[0][1], p['params']):.3g}, "
                  f"statistics {stats(two['stats'], js[0][2]):.3g}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    _spreads()
