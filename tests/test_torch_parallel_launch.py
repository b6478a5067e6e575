"""Starting the port's worlds: ``initialize_multihost``'s environment
against the JAX package's (``tests/test_multihost.py``), a world of one in
this process, a train CLI under ``python -m torch.distributed.run`` with
two CPU ranks (one log, one checkpoint, the same weights on both ranks),
and the Trainer with ``mesh_fsdp`` 2 choosing its best epoch alike on
every rank.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from simpleaicv_tpu.parallel import multihost as jax_multihost
from simpleaicv_tpu_torch.parallel import mesh as port_mesh
from simpleaicv_tpu_torch.parallel import multihost

import _torch_dist
from test_torch_trainer import _shrunk_recipe

REPO = Path(__file__).resolve().parents[1]
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    return monkeypatch


def _capture(monkeypatch):
    called = {}

    def fake_init(backend, init_method, world_size, rank, **kw):
        called.update(backend=backend, init=init_method, n=world_size,
                      pid=rank)

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    return called


def _jax_wiring(monkeypatch):
    called = {}

    def fake_init(coordinator_address, num_processes, process_id):
        called.update(addr=coordinator_address, n=num_processes,
                      pid=process_id)

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    return called


def test_no_coordinator_or_one_process_is_a_no_op(clean_env):
    called = _capture(clean_env)
    assert multihost.initialize_multihost() is False
    assert jax_multihost.initialize_multihost() is False
    clean_env.setenv("MASTER_ADDR", "10.0.0.1")
    clean_env.setenv("WORLD_SIZE", "1")
    assert multihost.initialize_multihost() is False
    assert not called
    assert multihost.is_main_process()


@pytest.mark.parametrize("env, init", [
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "2222", "WORLD_SIZE": "4",
      "RANK": "3"}, "env://"),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.2:3333", "JAX_NUM_PROCESSES": "8",
      "JAX_PROCESS_ID": "5"}, "tcp://10.0.0.2:3333")])
def test_environment_is_read_as_the_jax_package_reads_it(clean_env, env,
                                                         init):
    """The reference's (torchrun's) and the JAX package's variables give
    the JAX package's world size and rank; the reference's join through
    ``env://`` (a torchrun agent's store), a coordinator address through
    TCP; gloo under ``SIMPLEAICV_PLATFORM=cpu``."""
    for key, value in env.items():
        clean_env.setenv(key, value)
    called = _capture(clean_env)
    assert multihost.initialize_multihost() is True
    jax_called = _jax_wiring(clean_env)
    assert jax_multihost.initialize_multihost() is True
    assert (called["n"], called["pid"]) == (jax_called["n"],
                                            jax_called["pid"])
    assert called["backend"] == "gloo" and called["init"] == init


def test_nccl_without_a_card_raises(clean_env):
    clean_env.delenv("SIMPLEAICV_PLATFORM")
    clean_env.setenv("MASTER_ADDR", "10.0.0.1")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "0")
    _capture(clean_env)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert multihost.default_backend() == "nccl"
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.initialize_multihost()
    with pytest.raises(RuntimeError, match="NCCL"):
        multihost.initialize_multihost(backend="nccl")


def test_a_world_of_one_runs_in_this_process(tmp_path):
    def body():
        assert dist.get_world_size() == 1
        mesh = port_mesh.make_mesh(port_mesh.MeshConfig())
        t = torch.arange(3.0, requires_grad=True)
        s = port_mesh.global_sum(t)
        s.sum().backward()
        return (tuple(mesh.mesh.shape), mesh.mesh_dim_names, s.tolist(),
                t.grad.tolist(), port_mesh.sum_over_ranks([1.0, 2.0]).tolist())

    got = multihost.run_here(body, str(tmp_path), backend="gloo")
    assert got == ((1, 1), ("data", "fsdp"), [0.0, 1.0, 2.0],
                   [1.0, 1.0, 1.0], [1.0, 2.0])
    assert not dist.is_initialized()


def test_train_cli_under_torchrun_with_two_cpu_ranks(tmp_path):
    """``tests/_torch_dist.py`` runs the CLI's ``main`` and then saves each
    rank's weights."""
    _shrunk_recipe(tmp_path, epochs=1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", _torch_dist.__file__, "--work-dir",
         str(tmp_path)], cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
             "SIMPLEAICV_PLATFORM": "cpu"})
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"torchrun outlasted 60 s:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    assert ranks[0].keys() == ranks[1].keys()
    for key, value in ranks[0].items():
        assert torch.equal(value, ranks[1][key]), key
    # each rank reads 16 of the 32 samples: 4 steps of 4 rows
    assert "iter 4/4" in out
    logs = list((tmp_path / "log").iterdir())
    assert [p.name for p in logs] == ["train.log"]
    text = logs[0].read_text()
    assert text.count("epoch 1 done") == 1
    ckpt = tmp_path / "checkpoints"
    assert sorted(p.name for p in (ckpt / "latest").iterdir()) == ["1.pt"]
    assert (ckpt / "best").is_file()


def test_trainer_with_fsdp_takes_rank_0_s_best_epoch_on_every_rank(
        tmp_path):
    """Two ranks, ``mesh_fsdp`` 2, two epochs, and an evaluation that does
    not sum over the ranks: each rank scores the whole test set, and rank
    0's key metric decides the best epoch on both, so that both gather the
    sharded weights for it (rank 1's own scores would skip epoch 2's)."""
    _shrunk_recipe(tmp_path, epochs=2)
    metrics = [[0.1, 0.5], [0.9, 0.2]]
    ranks = _torch_dist.run("trainer_world", 2, tmp_path / "world",
                            {"work_dir": str(tmp_path), "metrics": metrics})
    for r in ranks:
        assert r["seen"] == [16, 16]       # the whole test set, each epoch
        assert r["best"] == 0.5
    for key, value in ranks[0]["weights"].items():
        np.testing.assert_array_equal(value, ranks[1]["weights"][key],
                                      err_msg=key)
    best = torch.load(tmp_path / "checkpoints" / "best", weights_only=True)
    assert best["metric"] == 0.5
    assert best["params"]["fc.weight"].shape == (10, 512)
