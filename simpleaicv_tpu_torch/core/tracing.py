"""Tracing and step timing (counterpart of
``simpleaicv_tpu/core/tracing.py``).

``trace(log_dir)`` records what runs inside it with ``torch.profiler``
(the host's operators and, where a card is present, its kernels through
CUPTI) and writes a Chrome trace, ``<log_dir>/trace.json``, which Perfetto
or ``chrome://tracing`` open. ``StepTimer`` times steps on the host's
clock; a step ends when the card has finished its work: ``stop`` waits on
``torch.cuda.synchronize`` or on a host copy of ``fetch_value``."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the block (CPU activity, and CUDA activity where a card is
    present) and writes ``<log_dir>/trace.json``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _fetch(value):
    """Copies ``value`` (a tensor, or a list, tuple or dict of them) to the
    host, which waits for the work that makes it."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _fetch(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_fetch(v) for v in value]
    return np.asarray(value)


class StepTimer:
    """Per-step wall-clock times; ``summary`` drops the first step (its
    warm-up) when there are others."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, fetch_value=None):
        if fetch_value is not None:
            _fetch(fetch_value)
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self):
        t = np.asarray(self.times[1:] or self.times)
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "p90_s": float(np.percentile(t, 90)), "steps": len(t)}
