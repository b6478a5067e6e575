"""Starting several processes (counterpart of
``simpleaicv_tpu/parallel/multihost.py``).

``initialize_multihost()`` reads the same environment as the JAX package's
(``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
then the reference's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``, which ``torchrun`` sets) and starts ``torch.distributed`` with it:
NCCL on the cards, gloo only when the caller asks for the CPU
(``SIMPLEAICV_PLATFORM=cpu`` or ``backend="gloo"``). A requested NCCL that
is missing raises; nothing falls back to gloo. Each process takes the card
of its ``LOCAL_RANK``.

``run_world`` is the port's own launcher: it starts a world of processes
on one machine, each calling one function, rendezvousing through a
``FileStore`` (no port to choose), and gives back what each returned. It
kills the world and raises when it outlasts its time limit. ``run_here``
runs a world of one in this process.
"""

from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import time
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.platform import device_from_env

__all__ = ["initialize_multihost", "is_main_process", "default_backend",
           "run_world", "run_here"]


def default_backend() -> str:
    """``"gloo"`` under ``SIMPLEAICV_PLATFORM=cpu``, else ``"nccl"``."""
    return "gloo" if device_from_env() == "cpu" else "nccl"


def _check_backend(backend: str):
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' (cards) or 'gloo' "
                         f"(CPU)")
    if backend == "nccl" and not (torch.cuda.is_available()
                                  and dist.is_nccl_available()):
        raise RuntimeError("NCCL requested but there is no CUDA card or no "
                           "NCCL; set SIMPLEAICV_PLATFORM=cpu (or pass "
                           "backend='gloo') to run on the CPU")


def _take_card(rank: int):
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(torch.cuda.device_count(), 1)))
    torch.cuda.set_device(local)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """No-op returning False for one process (or no coordinator in the
    arguments or the environment); otherwise starts the default process
    group and returns True."""
    coordinator_address = coordinator_address or \
        os.environ.get("JAX_COORDINATOR_ADDRESS")
    # the reference's (and torchrun's) environment: ``env://``, which joins
    # the store a torchrun agent already serves
    init_method = "env://"
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        os.environ.setdefault("MASTER_PORT", "1234")
    else:
        return False
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES",
                       os.environ.get("WORLD_SIZE", "1")))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", os.environ.get("RANK", "0")))
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    backend = backend or default_backend()
    _check_backend(backend)
    if backend == "nccl":
        _take_card(process_id)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def _start(store_path: str, rank: int, world: int, backend: str,
           timeout: float):
    _check_backend(backend)
    if backend == "nccl":
        _take_card(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


def run_here(fn, workdir: str, *args, backend: Optional[str] = None,
             timeout: float = 60.0):
    """``fn(*args)`` in this process as rank 0 of a world of one (a process
    group through a ``FileStore`` under ``workdir``), which is torn down
    after; returns what ``fn`` returned."""
    backend = backend or default_backend()
    os.makedirs(workdir, exist_ok=True)
    _start(os.path.join(workdir, "store"), 0, 1, backend, timeout)
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def run_world(target: str, world: int, workdir: str, args: Sequence = (), *,
              backend: Optional[str] = None, timeout: float = 60.0,
              pythonpath: Sequence[str] = ()) -> List[Any]:
    """Runs ``module:function`` in ``world`` new processes on this machine,
    ranks 0 to world - 1, each calling ``function(*args)`` inside a process
    group (``backend``, default ``default_backend()``) that rendezvouses
    through a ``FileStore`` under ``workdir``. Returns each rank's result
    (``torch.save``-able). Raises when a rank fails, naming its last
    output, and kills every rank and raises ``TimeoutError`` when the world
    outlasts ``timeout`` seconds. ``pythonpath`` entries go in front of the
    children's ``PYTHONPATH``; each child runs one intra-op thread, as
    ``torchrun`` sets it."""
    backend = backend or default_backend()
    os.makedirs(workdir, exist_ok=True)
    torch.save(list(args), os.path.join(workdir, "args.pt"))
    child_env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = os.pathsep.join(
        [*pythonpath, root, child_env.get("PYTHONPATH", "")]).rstrip(
            os.pathsep)
    child_env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(os.path.join(workdir, f"rank{rank}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, target, str(rank),
                 str(world), workdir, backend, str(timeout)],
                env=child_env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"world of {world} running {target} outlasted "
                    f"{timeout} s" + _tails(workdir, world))
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed:
            raise RuntimeError(f"rank {failed[0]} of {target} failed"
                               + _tails(workdir, world))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                       weights_only=False) for r in range(world)]


def _tails(workdir: str, world: int, nbytes: int = 3000) -> str:
    out = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.log")
        if os.path.exists(path):
            with open(path, "rb") as f:
                text = f.read()[-nbytes:].decode(errors="replace")
            out.append(f"\n--- rank {r} ---\n{text}")
    return "".join(out)


def _child(argv):
    target, rank, world, workdir, backend, timeout = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    _start(os.path.join(workdir, "store"), rank, world, backend,
           float(timeout))
    try:
        args = torch.load(os.path.join(workdir, "args.pt"),
                          weights_only=False)
        result = _resolve(target)(*args)
        tmp = os.path.join(workdir, f"result{rank}.pt.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(workdir, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1:])
