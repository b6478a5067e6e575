"""MACs and parameter counts (counterpart of
``simpleaicv_tpu/core/profile.py``), reported by the test CLI.

The parameter count comes from the module. The MACs are
``torch.utils.flop_counter.FlopCounterMode``'s operations over one eval
forward, halved (thop's convention, which the JAX package follows by
halving XLA's cost analysis); the counter sees matrix products and
convolutions, which is where ResNet's and ViT's operations are.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["count_params", "compute_macs_and_params", "format_macs_params"]


def count_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


@torch.no_grad()
def compute_macs_and_params(model: nn.Module, example_input):
    """(MACs, parameters) of ``model(example_input)`` in eval mode; the
    model's mode is put back after."""
    from torch.utils.flop_counter import FlopCounterMode
    was_training = model.training
    model.eval()
    try:
        with FlopCounterMode(display=False) as counter:
            model(example_input)
    finally:
        model.train(was_training)
    return counter.get_total_flops() / 2.0, count_params(model)


def format_macs_params(macs: float, params: int) -> str:
    def fmt(v, suffixes=("", "K", "M", "G", "T")):
        for s in suffixes:
            if abs(v) < 1000:
                return f"{v:.3f}{s}"
            v /= 1000
        return f"{v:.3f}P"

    return f"macs: {fmt(macs)}, params: {fmt(float(params))}"
