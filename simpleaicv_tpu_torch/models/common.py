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

``checkpoint`` recomputes a layer in the backward; BatchNorm layers inside
it (``ConvBnAct``) leave their running statistics alone during the
recomputation, which flax's ``nn.remat`` never runs twice.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from ..ops.fused_bn import FusedBatchNorm
from ..parallel.mesh import global_sum, world_size

__all__ = ["Linear", "Conv2d", "ConvTranspose2d", "BatchNorm", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Embed", "ConvBnAct", "max_pool_same",
           "DropPath", "drop_path", "dropout", "checkpoint", "norm_to",
           "checkpoint_replaying", "resolve_device", "init_params"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when there is no card,
    so a CUDA entry point never carries on quietly on the CPU. ``"cuda"``
    names the current card with its index."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           f"available; pass device='cpu' to run on the CPU")
    if device.type == "cuda" and device.index is None:
        # the process's own card (a rank's, set by initialize_multihost),
        # so that every comparison of devices names the same index
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Linear(nn.Module):
    """flax ``nn.Dense(dtype=...)``: x @ W.T + b computed in ``dtype``.

    Initialisers: lecun normal (flax's default), a truncated normal
    (``init_std``) or zeros (``zero_weight``); the bias is zero unless
    ``bias_fill`` (a number or a tensor of the bias's shape) is given."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 init_std: float | None = None, zero_weight: bool = False,
                 bias_fill=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.dtype = dtype
        self.init_std = init_std  # truncated normal instead of lecun normal
        self.zero_weight = zero_weight
        self.bias_fill = bias_fill

    def reset_parameters(self, generator):
        if self.zero_weight:
            nn.init.zeros_(self.weight)
        elif self.init_std is None:
            _lecun_normal(self.weight, self.weight.shape[1], generator)
        else:
            truncated_normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.copy_(torch.as_tensor(
                    0.0 if self.bias_fill is None else self.bias_fill,
                    dtype=self.bias.dtype).expand_as(self.bias))

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Module):
    """flax ``nn.Conv(dtype=...)`` on NHWC tensors; weight OIHW (O, I /
    groups, kH, kW). ``dilation`` is flax's ``kernel_dilation``, ``groups``
    its ``feature_group_count``; ``kernel_size`` and ``padding`` are a
    number or an (h, w) pair. Initialisers: lecun normal (flax's default)
    or a normal of deviation ``normal_std``; the bias is ``bias_fill``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride: int = 1, padding=0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, dilation: int = 1,
                 groups: int = 1, normal_std: float | None = None,
                 bias_fill: float = 0.0):
        super().__init__()
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.dilation, self.groups = dilation, groups
        self.normal_std, self.bias_fill = normal_std, bias_fill

    def reset_parameters(self, generator):
        if self.normal_std is None:
            _lecun_normal(self.weight, self.weight[0].numel(), generator)
        else:
            with torch.no_grad():
                self.weight.copy_(torch.randn(self.weight.shape,
                                              generator=generator)
                                  * self.normal_std)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_fill)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose(dtype=...)`` on NHWC tensors, computed in
    ``dtype`` from f32 parameters; weight IOHW as torch stores it, which
    ``core.weights`` flips spatially against flax's kernel. ``padding`` is
    torch's: flax's explicit padding ``p`` per side on the stride-dilated
    input is torch's ``kernel_size - 1 - p`` (kernel 4, stride 2, flax
    ((2, 2), (2, 2)) -> torch 1: exactly twice the input's size); with
    kernel == stride both are 0."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def reset_parameters(self, generator):
        fan_in = self.weight.shape[0] * self.weight[0, 0].numel()
        _lecun_normal(self.weight, fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), b, self.stride,
                               self.padding)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the last axis of an NHWC tensor, as flax 0.12 computes it (unlike
    ``ops.fused_bn``): train-mode statistics in f32 as ``E[x]`` and
    ``max(E[x^2] - E[x]^2, 0)``, with no shift; the running variance blends
    this *biased* batch variance; the output ``(x - mean) * (scale *
    rsqrt(var + eps)) + bias`` in f32, differentiated by autograd through
    the statistics. In a world of several ranks the statistics are the
    global batch's (sums over the ranks, ``parallel.mesh.global_sum``). Parameters ``weight`` and ``bias`` (flax ``scale`` and
    ``bias``), buffers ``running_mean`` and ``running_var`` (flax
    ``batch_stats`` ``mean`` and ``var``)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, train: bool, update_stats: bool = True):
        """``train`` selects the batch statistics; ``update_stats`` (train
        mode only) blends them into the running ones, which a recomputation
        in the backward must not do a second time (``norm_to``)."""
        xf = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            if world_size() > 1:
                # the global batch's statistics, differentiated through
                # the sum over ranks
                c = x.shape[-1]
                sums = global_sum(torch.cat([
                    xf.sum(dim=dims), xf.square().sum(dim=dims),
                    xf.new_full((1,), float(x.numel() // c))]))
                mean = sums[:c] / sums[-1]
                sq = sums[c:2 * c] / sums[-1]
            else:
                mean = xf.mean(dim=dims)
                sq = xf.square().mean(dim=dims)
            var = torch.clamp(sq - mean.square(), min=0.0)
            if update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def norm_to(bn: BatchNorm, x, train: bool, dtype: torch.dtype):
    """``bn``'s f32 output cast to ``dtype``, as the JAX models cast flax's
    BatchNorm; a recomputation in the backward (``checkpoint``) leaves the
    running statistics alone."""
    return bn(x, train, update_stats=not recomputing()).to(dtype)


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


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, epsilon=1e-5)`` on an NHWC tensor, in
    f32: ``weight`` and ``bias`` are flax's ``scale`` and ``bias``."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class InstanceNorm(nn.Module):
    """flax ``nn.InstanceNorm(epsilon=1e-5, use_bias=False,
    use_scale=False)`` on an NHWC tensor, as flax 0.12 computes it: no
    parameters; per sample and channel over H and W, in f32, ``E[x]`` and
    ``max(E[x^2] - E[x]^2, 0)`` with no shift (``use_fast_variance``),
    output ``(x - mean) * rsqrt(var + eps)`` in f32."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = torch.clamp(xf.square().mean(dim=(1, 2), keepdim=True)
                          - mean.square(), min=0.0)
        return (xf - mean) * torch.rsqrt(var + self.eps)


class Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``weight`` (flax's ``embedding``)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape,
                                          generator=generator)
                              / math.sqrt(self.weight.shape[1]))

    def forward(self, ids):
        # a lookup, not ``weight[ids]``: indexing with a 0-d tensor reads
        # the index on the host, which ``torch.export`` cannot trace
        return F.embedding(ids, self.weight)


_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = False


def recomputing() -> bool:
    """True while ``checkpoint`` recomputes a layer in the backward."""
    return getattr(_recompute, "active", False)


def checkpoint(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``); ``recomputing()`` is True
    during the recomputation."""
    return torch_checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def checkpoint_replaying(fn, generator, *args):
    """``checkpoint(fn, *args, generator)`` for a layer that draws dropout
    or drop-path masks from ``generator``: the recomputation replays the
    generator from the state it had before the layer, so it draws the same
    masks, and then puts the generator back where the backward found
    it."""
    if generator is None:
        return checkpoint(fn, *args, None)
    before = generator.get_state()
    calls = []

    def run(*xs):
        if not calls:
            calls.append(1)
            return fn(*xs, generator)
        now = generator.get_state()
        generator.set_state(before)
        try:
            return fn(*xs, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args)


class ConvBnAct(nn.Module):
    """conv -> BatchNorm -> ReLU on NHWC tensors (flax ``ConvBnAct``,
    ``simpleaicv_tpu/models/common.py:97-146``): the convolution in
    ``dtype`` from f32 parameters, without a bias when there is a BatchNorm;
    the BatchNorm's statistics in f32 (``ops.fused_bn``); the output in
    ``dtype``. ``kernel_size`` and ``stride`` are a number or an (h, w)
    pair (the OCR trunk's stages); padding ``(k - 1) // 2`` on each
    axis. ``act`` is the activation (ReLU; DarkNet's LeakyReLU 0.1)."""

    def __init__(self, in_planes: int, planes: int, kernel_size=3,
                 stride=1, has_bn: bool = True, has_act: bool = True,
                 dtype: torch.dtype = torch.bfloat16, act=F.relu):
        super().__init__()
        padding = ((kernel_size - 1) // 2 if isinstance(kernel_size, int)
                   else tuple((k - 1) // 2 for k in kernel_size))
        self.conv = Conv2d(in_planes, planes, kernel_size, stride, padding,
                           bias=not has_bn, dtype=dtype)
        self.bn = FusedBatchNorm(planes) if has_bn else None
        self.has_act, self.dtype, self.act = has_act, dtype, act

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train, update_stats=not recomputing())
            x = x.to(self.dtype)
        return self.act(x) if self.has_act else x


def max_pool_same(x, window: int, stride: int):
    """flax ``max_pool`` with ``(window - 1) // 2`` padding on each side
    (padding never wins) on an NHWC tensor."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                     (window - 1) // 2)
    return y.permute(0, 2, 3, 1)


def dropout(x, prob: float, training: bool, generator=None):
    """flax ``nn.Dropout``: zeroes elements with probability ``prob`` and
    scales the rest by 1 / (1 - prob). The mask comes from ``generator`` (on
    x's device), or from torch's global generator when it is None."""
    if prob == 0.0 or not training:
        return x
    keep = 1.0 - prob
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return x * (mask.to(x.dtype) / keep)


class DropPath(nn.Module):
    """Stochastic depth: in training each sample's branch is dropped with
    probability ``drop_path_prob`` and the kept ones are scaled by 1 / keep
    (``scale_by_keep``). One mask value per sample, from ``generator``."""

    def __init__(self, drop_path_prob: float = 0.0,
                 scale_by_keep: bool = True):
        super().__init__()
        self.drop_path_prob = drop_path_prob
        self.scale_by_keep = scale_by_keep

    def forward(self, x, generator=None):
        return drop_path(x, self.drop_path_prob, self.training, generator,
                         self.scale_by_keep)


def drop_path(x, prob: float, training: bool, generator=None,
              scale_by_keep: bool = True):
    """``DropPath``'s function, for a caller that passes ``train`` rather
    than setting the module's mode."""
    if prob == 0.0 or not training:
        return x
    keep = 1.0 - prob
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = (torch.rand(shape, device=x.device, generator=generator)
            < keep).to(x.dtype)
    if scale_by_keep:
        mask = mask / keep
    return x * mask


def truncated_normal_(tensor, stddev, generator):
    """flax ``truncated_normal(stddev)``: a normal cut at two standard
    deviations and rescaled so that the result's deviation is ``stddev``."""
    std = stddev / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def _lecun_normal(weight, fan_in, generator):
    """flax's ``lecun_normal``: a truncated normal of deviation
    1 / sqrt(fan_in) (``variance_scaling(1, "fan_in",
    "truncated_normal")``), not a plain normal."""
    truncated_normal_(weight, 1.0 / math.sqrt(fan_in), generator)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fills every parameter of ``module`` from ``generator``, module by
    module in registration order (each module's ``reset_parameters``)."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
