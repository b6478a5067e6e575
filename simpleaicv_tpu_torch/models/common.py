"""Layers with the JAX package's compute-dtype handling, and device and
parameter helpers.

The JAX package keeps f32 master parameters and casts each layer's inputs
and parameters to a compute dtype at call time (``dtype=cdtype()`` on flax
``Dense``/``Conv``, ``simpleaicv_tpu/models/common.py:26-43``). The port
does the same with an explicit ``dtype`` per layer rather than
``torch.autocast`` or a global setting: parameters stay f32 and ``forward``
casts. Activations keep the JAX package's NHWC layout.

Parameters are created empty; ``init_params`` fills them from an explicit
``torch.Generator``, and ``core.weights.load_jax_params`` or
``load_state_dict`` supply trained ones.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Linear", "Conv2d", "ConvTranspose2d", "LayerNorm",
           "resolve_device", "init_params"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is no card,
    so a CUDA entry point never carries on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    return device


class Linear(nn.Module):
    """flax ``nn.Dense(dtype=...)``: x @ W.T + b computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.dtype = dtype

    def reset_parameters(self, generator):
        _lecun_normal(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Module):
    """flax ``nn.Conv(dtype=...)`` on NHWC tensors; weight OIHW."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def reset_parameters(self, generator):
        _lecun_normal(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose(dtype=float32)`` with kernel == stride on
    NHWC tensors; weight IOHW as torch stores it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.stride = stride

    def reset_parameters(self, generator):
        fan_in = self.weight.shape[0] * self.weight[0, 0].numel()
        _lecun_normal(self.weight, fan_in, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), self.weight,
                               self.bias, self.stride)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 output, eps 1e-6 (flax's
    default; torch's is 1e-5)."""

    eps = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps)


def _lecun_normal(weight, fan_in, generator):
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator)
                     * (1.0 / math.sqrt(fan_in)))


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fills every parameter of ``module`` from ``generator``, module by
    module in registration order (each module's ``reset_parameters``)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
