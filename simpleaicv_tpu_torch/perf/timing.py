"""Device timing and roofline bounds on the card.

The peaks are an NVIDIA H100 SXM's dense rates (NVIDIA's data sheet) at the
full 700 W power limit; a card set below it runs slower under load, so a
reading names the card and its limit beside it.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up,
    by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype):
    """(bound_ms, bound_by): the larger of the operations over the card's
    peak rate for their type and the bytes over its memory rate."""
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def alternating_ms(fns: dict, rounds: int = 5, iters: int = 20) -> dict:
    """Device times of each of ``fns`` (name -> callable), taken in turns:
    every round times each function once, in the dict's order, as the mean
    of ``iters`` launches after a warm-up (``cuda_ms``). Returns
    {name: [ms of each round]}, so that a reading carries its spread and
    a drift of the card between rounds falls on every function alike."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(cuda_ms(fn, iters))
    return out
