"""Host input pipeline (counterpart of ``simpleaicv_tpu/data/loader.py``).

Each epoch reshuffles with ``np.random.RandomState(seed + epoch)`` and hands
process ``rank`` of ``world`` (torch.distributed's, or 0 of 1) its
contiguous share of the order, as ``DistributedSampler`` does and as the
JAX loader does. With ``accumulation_steps`` above 1 in a world above 1,
a rank reads other rows of the same global batch (``rank_indices``): the
JAX engine splits the *global* batch into contiguous micro-batches, and
rank ``r``'s micro-batch ``i`` is its slice of global micro-batch ``i``.
Within a process, workers build the batches ahead of the consumer:

* ``worker_mode="thread"`` (the default): a thread pool with a bounded
  window of per-sample futures and a bounded queue of collated batches,
  right where the per-sample work releases the GIL (numpy, the torch
  resize);
* ``worker_mode="process"``: a pool of worker processes, one collated batch
  per task, right for GIL-bound Python augmentation. The workers are
  started with ``spawn`` (the caller may hold CUDA and threads, which a
  forked child must not inherit): the dataset and the collater are pickled
  to each worker, which imports the port afresh. Before it builds a batch,
  the worker seeds its global ``random`` and ``numpy.random`` from (seed,
  epoch, batch index), so the transforms that draw from the global state
  give the same batches on every run, whichever worker takes which batch,
  and other draws in other epochs. This departs from the JAX package: its
  forked workers inherit an unseeded ``random`` (CPython reseeds it in each
  child) and a copy of the parent's numpy state, so every worker draws the
  same numpy sequence. A transform's own generator is copied to each worker
  as it is.

Batches come out in the same order in both modes, and a dataset or collater
exception is raised in the consumer. The producer never blocks on a full
queue once the consumer has stopped, so neither side can hang.
"""

from __future__ import annotations

import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from ..core.platform import process_count, process_index
from ..parallel.mesh import rows_of

__all__ = ["DataLoader", "rank_indices"]

# a worker process's dataset, collater, seed and epoch, set by its
# initializer
_WORKER_DS = None
_WORKER_COLLATE = None
_WORKER_SEED = (0, 0)


def _proc_init(ds, collate, seed, epoch):
    global _WORKER_DS, _WORKER_COLLATE, _WORKER_SEED
    _WORKER_DS, _WORKER_COLLATE = ds, collate
    _WORKER_SEED = (seed, epoch)


def _batch_seeds(seed: int, epoch: int, batch: int) -> tuple[int, int]:
    """The seeds of ``random`` and ``numpy.random`` for one batch of one
    epoch."""
    py, nps = np.random.SeedSequence([seed, epoch, batch]).generate_state(2)
    return int(py), int(nps)


def _proc_fetch_batch(task):
    batch, idxs = task
    py, nps = _batch_seeds(*_WORKER_SEED, batch)
    random.seed(py)
    np.random.seed(nps)
    return _WORKER_COLLATE([_WORKER_DS[int(i)] for i in idxs])


def rank_indices(order: np.ndarray, rank: int, world: int,
                 local_batch: int, accumulation_steps: int = 1):
    """Rank ``rank``'s sample indices for an epoch of ``order``, batch
    ``b`` at ``[b * local_batch, (b + 1) * local_batch)``. The JAX loader
    gives process ``p`` the contiguous ``order[p * per:(p + 1) * per]``
    and its global batch ``b`` is the processes' batches ``b`` one after
    the other; here rank ``r``'s batch ``b`` is ``rows_of`` that global
    batch, which with one micro-batch is process ``r``'s own batch. Rows
    past the last whole batch stay the JAX loader's."""
    per = len(order) // world
    mine = order[rank * per:(rank + 1) * per]
    if world == 1 or accumulation_steps == 1:
        return mine
    nb = per // local_batch
    shards = order[:world * per].reshape(world, per)[:, :nb * local_batch]
    glob = shards.reshape(world, nb, local_batch).transpose(1, 0, 2)
    rows = rows_of(glob.reshape(nb, world * local_batch), rank, world,
                   accumulation_steps)
    return np.concatenate([rows.reshape(-1), mine[nb * local_batch:]])


class DataLoader:

    def __init__(self, dataset, batch_size: int, collater: Callable,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 4,
                 worker_mode: str = "thread", accumulation_steps: int = 1,
                 shard: bool = True):
        """``batch_size`` is the global batch; each process takes its
        ``batch_size / world`` share, split for ``accumulation_steps``
        micro-batches as ``rank_indices`` says. With ``shard=False`` every
        process reads the whole dataset in batches of ``batch_size``, as
        one process does."""
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', "
                             f"got {worker_mode!r}")
        self.shard = shard
        n_proc = self._world()[1]
        if batch_size % n_proc:
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{n_proc} processes")
        self.dataset = dataset
        self.local_batch_size = batch_size // n_proc
        self.collater = collater
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self.accumulation_steps = max(int(accumulation_steps), 1)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _world(self) -> tuple[int, int]:
        """(this process's index, the number of processes) the dataset is
        split over."""
        return (process_index(), process_count()) if self.shard else (0, 1)

    def __len__(self):
        n = len(self.dataset) // self._world()[1]
        if self.drop_last:
            return n // self.local_batch_size
        return (n + self.local_batch_size - 1) // self.local_batch_size

    def _local_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        return rank_indices(order, *self._world(), self.local_batch_size,
                            self.accumulation_steps)

    def _iter_process(self, indices, bs, n_batches) -> Iterator:
        """One task per collated batch, at most ``prefetch + num_workers``
        in flight (a semaphore), results in order through ``imap``."""
        import multiprocessing as mp
        sem = threading.Semaphore(self.prefetch + self.num_workers)
        stop = threading.Event()

        def tasks():
            for b in range(n_batches):
                while not stop.is_set():
                    if sem.acquire(timeout=0.05):
                        break
                else:
                    return
                if stop.is_set():
                    return
                yield b, list(indices[b * bs:min((b + 1) * bs,
                                                  len(indices))])

        pool = mp.get_context("spawn").Pool(
            self.num_workers, initializer=_proc_init,
            initargs=(self.dataset, self.collater, self.seed, self.epoch))
        try:
            for batch in pool.imap(_proc_fetch_batch, tasks()):
                sem.release()
                yield batch
        finally:
            stop.set()
            pool.terminate()
            pool.join()

    def __iter__(self) -> Iterator:
        indices = self._local_indices()
        bs = self.local_batch_size
        n_batches = len(self)
        n_samples = n_batches * bs if self.drop_last else len(indices)
        if self.worker_mode == "process":
            yield from self._iter_process(indices, bs, n_batches)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_stoppable(obj):
            """A put that gives up once the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.05)
                    return
                except queue.Full:
                    continue

        def producer():
            """Per-sample futures in a bounded window, collated in order; a
            dataset or collater exception is handed to the consumer, and the
            end-of-epoch sentinel is always delivered unless the consumer
            has stopped."""
            err = None
            try:
                window = self.num_workers + bs * max(self.prefetch, 1)
                with ThreadPoolExecutor(self.num_workers) as pool:
                    inflight: deque = deque()
                    next_i = 0
                    cur = []
                    done = 0
                    while done < n_samples and not stop.is_set():
                        while next_i < n_samples and len(inflight) < window:
                            inflight.append(
                                pool.submit(self.dataset.__getitem__,
                                            int(indices[next_i])))
                            next_i += 1
                        cur.append(inflight.popleft().result())
                        done += 1
                        if len(cur) == bs:
                            put_stoppable(self.collater(cur))
                            cur = []
                    if cur and not self.drop_last and not stop.is_set():
                        put_stoppable(self.collater(cur))
                    for f in inflight:
                        f.cancel()
            except Exception as e:  # noqa: BLE001 (raised in the consumer)
                err = e
            put_stoppable(err if err is not None else StopIteration)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is StopIteration:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain, so that the producer sees ``stop`` and exits
            while True:
                try:
                    if q.get_nowait() is StopIteration:
                        break
                except queue.Empty:
                    break
