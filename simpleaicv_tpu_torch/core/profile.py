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


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """The operations of ``aten.bmm``, its ``out_dtype`` overload included
    (the MoE expert products): the counter's own formula takes that
    overload's third argument, the dtype, for the output shape and
    raises."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def count_params(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


@torch.no_grad()
def compute_macs_and_params(model: nn.Module, example_input):
    """(MACs, parameters) of ``model(example_input)`` in eval mode; the
    model's mode is put back after. The parameters stop requiring gradients
    meanwhile: the counter's module tracker hooks every module input that
    requires one, and a view of a parameter taken under ``no_grad`` (a
    broadcast query embedding) requires one but has no gradient function."""
    from torch.utils.flop_counter import FlopCounterMode
    was_training = model.training
    grads = [(p, p.requires_grad) for p in model.parameters()]
    model.eval()
    try:
        for p, _ in grads:
            p.requires_grad_(False)
        with FlopCounterMode(display=False, custom_mapping={
                torch.ops.aten.bmm: _bmm_flop}) as counter:
            model(example_input)
    finally:
        for p, req in grads:
            p.requires_grad_(req)
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
