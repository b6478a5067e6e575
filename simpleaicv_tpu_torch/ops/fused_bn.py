"""Train-mode BatchNorm with the JAX package's semantics (counterpart of
``simpleaicv_tpu/ops/fused_bn.py``), in plain PyTorch on every device.

* Train mode: f32 statistics over N, H and W of an NHWC tensor, shifted by
  the running mean (``var = E[(x - c)^2] - E[x - c]^2`` with ``c`` the
  running mean, exact for any ``c``), biased; the output
  ``(x - mean) * (gamma * rstd) + beta`` in x's dtype. The backward is the
  JAX package's custom VJP: two sums over (dy, x) and one elementwise pass,
  centred on ``x - mean``; the running mean is not differentiated.
* The running mean blends the batch mean and the running variance the
  unbiased batch variance (n / (n - 1)), with the flax momentum 0.9 (torch
  momentum 0.1); eps 1e-5.
* Eval mode: the centred form ``(x - running_mean) * (gamma * rstd) +
  beta`` in f32, cast to x's dtype.

No hand kernel: one waits for a measurement on the card that asks for it.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["bn_train", "FusedBatchNorm"]

_DIMS = (0, 1, 2)


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, shift, eps):
        n = x.shape[0] * x.shape[1] * x.shape[2]
        c = shift.detach().float()
        xs = x.float() - c
        d = xs.sum(dim=_DIMS) / n
        mean = c + d
        var = xs.square().sum(dim=_DIMS) / n - d.square()
        del xs
        rstd = torch.rsqrt(var + eps)
        scale = (gamma * rstd).to(x.dtype)
        y = (x - mean.to(x.dtype)) * scale + beta.to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the mean and var cotangents are zero: they only feed the running
        # statistics, which are not differentiated
        x, gamma, mean, rstd = ctx.saved_tensors
        n = x.shape[0] * x.shape[1] * x.shape[2]
        dyf, xc = dy.float(), x.float() - mean
        s_dy = dyf.sum(dim=_DIMS)
        s_dyxhat = rstd * (dyf * xc).sum(dim=_DIMS)
        a = gamma * rstd
        k = a * (rstd / n) * s_dyxhat          # coefficient of (x - mean)
        dx = (dyf * a - xc * k - a * (s_dy / n)).to(x.dtype)
        return dx, s_dyxhat, s_dy, None, None


def bn_train(x, gamma, beta, shift, eps: float):
    """Train-mode BN of an NHWC tensor: (y in x's dtype, biased batch mean
    f32, biased batch var f32). ``shift`` (the running mean) only steadies
    the f32 statistics and carries no gradient."""
    return _BNTrain.apply(x, gamma, beta, shift, eps)


class FusedBatchNorm(nn.Module):
    """BatchNorm over the last axis of an NHWC tensor. Parameters ``weight``
    and ``bias`` (flax ``scale`` and ``bias``), buffers ``running_mean`` and
    ``running_var`` (flax ``batch_stats`` ``mean`` and ``var``)."""

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
        in the backward must not do a second time."""
        if not train:
            rstd = torch.rsqrt(self.running_var + self.eps)
            xc = x.float() - self.running_mean
            return (xc * (self.weight * rstd) + self.bias).to(x.dtype)
        y, mean, var = bn_train(x, self.weight, self.bias, self.running_mean,
                                self.eps)
        if update_stats:
            n = x.numel() // x.shape[-1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_(
                    (1 - m) * (n / max(n - 1, 1)) * var)
        return y
