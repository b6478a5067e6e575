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

In a world of several ranks the statistics are those of the global batch,
as the JAX engine's are (its BatchNorm is "always sync"): the forward sums
the shifted sums, the squared sums and the count over the ranks
(``parallel.mesh.global_sum``, one collective), and the backward sums its
two reductions the same way for ``dx``; the gradients of ``gamma`` and
``beta`` stay this rank's own, which the engine's mean over ranks makes
the global batch's. In a world of one none of this runs: the count is the
Python int of the batch's rows.

No hand kernel: one waits for a measurement on the card that asks for it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import global_sum, world_size

__all__ = ["bn_train", "FusedBatchNorm"]

_DIMS = (0, 1, 2)


class _BNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, shift, eps, synced):
        n = x.shape[0] * x.shape[1] * x.shape[2]
        c = shift.detach().float()
        xs = x.float() - c
        s, ss = xs.sum(dim=_DIMS), xs.square().sum(dim=_DIMS)
        del xs
        if synced:
            # the sums and the count of every rank, in one collective
            k = c.shape[0]
            sums = global_sum(torch.cat([s, ss, s.new_full((1,), float(n))]))
            s, ss, n = sums[:k], sums[k:2 * k], sums[2 * k]
        d = s / n
        mean = c + d
        var = ss / n - d.square()
        rstd = torch.rsqrt(var + eps)
        scale = (gamma * rstd).to(x.dtype)
        y = (x - mean.to(x.dtype)) * scale + beta.to(x.dtype)
        ctx.synced = synced
        if synced:
            ctx.save_for_backward(x, gamma, mean, rstd, n)
            ctx.mark_non_differentiable(mean, var, n)
            return y, mean, var, n
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, *_):
        # the mean, var (and count) cotangents are zero: they only feed the
        # running statistics, which are not differentiated
        if ctx.synced:
            x, gamma, mean, rstd, n = ctx.saved_tensors
        else:
            x, gamma, mean, rstd = ctx.saved_tensors
            n = x.shape[0] * x.shape[1] * x.shape[2]
        dyf, xc = dy.float(), x.float() - mean
        s_dy = dyf.sum(dim=_DIMS)
        s_dyxhat = rstd * (dyf * xc).sum(dim=_DIMS)
        g_dy, g_dyxhat = s_dy, s_dyxhat
        if ctx.synced:
            c = s_dy.shape[0]
            sums = global_sum(torch.cat([s_dy, s_dyxhat]))
            g_dy, g_dyxhat = sums[:c], sums[c:]
        a = gamma * rstd
        k = a * (rstd / n) * g_dyxhat          # coefficient of (x - mean)
        dx = (dyf * a - xc * k - a * (g_dy / n)).to(x.dtype)
        return dx, s_dyxhat, s_dy, None, None, None


def _bn_train(x, gamma, beta, shift, eps: float):
    """(y, mean, var, n): ``bn_train`` and the count of rows its statistics
    are over, a Python int in a world of one, else the ranks' summed count
    (a 0-d f32 tensor, no host read)."""
    if world_size() > 1:
        return _BNTrain.apply(x, gamma, beta, shift, eps, True)
    return (*_BNTrain.apply(x, gamma, beta, shift, eps, False),
            x.numel() // x.shape[-1])


def bn_train(x, gamma, beta, shift, eps: float):
    """Train-mode BN of an NHWC tensor: (y in x's dtype, biased batch mean
    f32, biased batch var f32). ``shift`` (the running mean) only steadies
    the f32 statistics and carries no gradient. The statistics are the
    global batch's in a world of several ranks."""
    return _bn_train(x, gamma, beta, shift, eps)[:3]


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
        y, mean, var, n = _bn_train(x, self.weight, self.bias,
                                    self.running_mean, self.eps)
        if update_stats:
            m = self.momentum
            if torch.is_tensor(n):
                n = n.double()
                unbias = (n / (n - 1).clamp(min=1)).float()
            else:
                unbias = n / max(n - 1, 1)
            with torch.no_grad():
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * unbias * var)
        return y
