"""GPipe pipeline parallelism (counterpart of
``simpleaicv_tpu/parallel/pipeline.py``).

The JAX package runs the pipeline as one SPMD program over a ``('data',
'pipe')`` mesh: each device holds one stage, microbatches ride a
``ppermute`` ring, and ``jax.grad`` through the tick loop derives the
backward schedule. The port runs one process per stage and writes the same
fill-and-drain schedule out with point-to-point sends:

* each rank of the ``pipe`` dim keeps only its own stage (a module, or any
  callable of one activation tensor), ``stack_stage_params``;
* ``pipeline_forward``: stage 0 reads the microbatches; stage ``s`` takes
  microbatch ``m`` from stage ``s - 1``, runs it, and sends it on to
  ``s + 1`` (``dist.send``/``recv`` inside autograd Functions whose
  backward sends the gradient back the other way); the last stage's
  outputs are broadcast to every stage, and only its copy carries a
  gradient, so the loss every stage computes from them counts once;
* each stage's gradient stays on its rank: no collective over ``pipe``;
  the loss and the stage gradients are averaged over ``data``.

The microbatches of one rank are chained (each one's first step depends on
a zero-size piece of the one before), so autograd runs their backward last
microbatch first on every stage and the sends and receives of the two
passes pair up in the same order on both sides of each link.

As in the JAX package, a stage maps activations of one shape to the same
shape, and the ``pipe`` dim's size is the number of stages. The bubble is
(S - 1) / (M + S - 1).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models.common import checkpoint

__all__ = ["make_pipeline_mesh", "stack_stage_params", "pipeline_forward",
           "make_pipeline_loss_fn", "make_pipeline_train_step"]


def make_pipeline_mesh(n_pipe: int):
    """A ``('data', 'pipe')`` ``DeviceMesh`` of the world, the ``pipe``
    ring on the minor dim (ranks ``d * n_pipe`` to ``d * n_pipe + n_pipe -
    1`` form data slice ``d``'s pipeline)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    assert n % n_pipe == 0, f"{n} ranks not divisible by pipe={n_pipe}"
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // n_pipe, n_pipe),
                            mesh_dim_names=("data", "pipe"))


def stack_stage_params(per_stage: list, mesh, axis: str = "pipe"):
    """This rank's stage of ``per_stage`` (one entry per stage): each rank
    keeps only its own."""
    assert len(per_stage) == mesh[axis].size(), (len(per_stage),
                                                 mesh[axis].size())
    return per_stage[mesh[axis].get_local_rank()]


def _peer(group, offset: int) -> int:
    r, s = dist.get_rank(group), dist.get_world_size(group)
    return dist.get_global_rank(group, (r + offset) % s)


class _Send(torch.autograd.Function):
    """Sends ``y`` on; returns a zero-size link. The backward receives
    ``y``'s gradient from the same peer."""

    @staticmethod
    def forward(ctx, y, dst, group):
        dist.send(y.detach().contiguous(), dst, group)
        ctx.dst, ctx.group = dst, group
        ctx.shape, ctx.dtype = y.shape, y.dtype
        return y.new_zeros(0)

    @staticmethod
    def backward(ctx, _link_grad):
        grad = torch.empty(ctx.shape, dtype=ctx.dtype,
                           device=_link_grad.device)
        dist.recv(grad, ctx.dst, ctx.group)
        return grad, None, None


class _Recv(torch.autograd.Function):
    """Receives an activation after ``link`` (the previous microbatch's);
    the backward sends its gradient back to the same peer."""

    @staticmethod
    def forward(ctx, link, shape, dtype, src, group):
        out = torch.empty(shape, dtype=dtype, device=link.device)
        dist.recv(out, src, group)
        ctx.src, ctx.group = src, group
        return out

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.src, ctx.group)
        return grad.new_zeros(0), None, None, None, None


class _After(torch.autograd.Function):
    """``x`` itself, ordered after ``link`` in the backward."""

    @staticmethod
    def forward(ctx, x, link):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, grad.new_zeros(0)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every stage of ``group``; only the last
    stage's copy passes a gradient back, and ``links`` (the sends of this
    stage) start the backward of the stage."""

    @staticmethod
    def forward(ctx, outs, last, group, *links):
        outs = outs.contiguous().clone()
        dist.broadcast(outs, last, group)
        ctx.is_last = dist.get_rank() == last
        ctx.n_links = len(links)
        return outs

    @staticmethod
    def backward(ctx, grad):
        g = grad if ctx.is_last else torch.zeros_like(grad)
        return (g, None, None) + tuple(grad.new_zeros(0)
                                       for _ in range(ctx.n_links))


def pipeline_forward(stage_fn: Callable, x_micro, *, group=None,
                     remat: bool = False):
    """The fill-and-drain microbatch pipeline over the ranks of ``group``
    (the ``pipe`` dim; stage ``s`` is the group's rank ``s``).

    stage_fn: this rank's stage, activation -> activation of the same
        shape and dtype.
    x_micro: [M, micro_batch, ...] microbatches (every stage passes them;
        only stage 0 reads them).
    Returns [M, micro_batch, ...], the last stage's outputs, on every stage;
    differentiable with respect to each stage's parameters on its rank.
    """
    s = dist.get_world_size(group)
    stage = dist.get_rank(group)
    fn = (lambda x: checkpoint(stage_fn, x)) if remat else stage_fn
    m = x_micro.shape[0]
    link = x_micro.new_zeros(0, requires_grad=True)
    outs, sends = [], []
    for i in range(m):
        if stage == 0:
            inp = _After.apply(x_micro[i], link)
        else:
            inp = _Recv.apply(link, x_micro.shape[1:], x_micro.dtype,
                              _peer(group, -1), group)
        y = fn(inp)
        if stage < s - 1:
            link = _Send.apply(y, _peer(group, 1), group)
            sends.append(link)
        else:
            outs.append(y)
            link = y.reshape(-1)[:0]
    local = torch.stack(outs) if outs else torch.zeros_like(x_micro)
    last = dist.get_global_rank(group, s - 1) if group is not None else s - 1
    return _FromLast.apply(local, last, group, *sends)


class _DataMean(torch.autograd.Function):
    """The mean over ``group``'s ranks; each rank's gradient is its own
    share (1 / D), the stage gradients being summed over the group
    after."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.d = dist.get_world_size(group)
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / ctx.d

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.d, None


def make_pipeline_loss_fn(stage_fn: Callable, loss_fn: Callable, mesh, *,
                          n_micro: int, remat: bool = False):
    """``loss(x, y)``: this rank's data slice ``x`` [B_local, ...] split into
    ``n_micro`` microbatches, run through the pipeline, ``loss_fn(pred,
    true)`` (a microbatch mean) averaged over the microbatches and then
    over ``data``. Its backward leaves on each rank ``1 / D`` of its own
    slice's stage gradient; ``make_pipeline_train_step`` sums them over
    ``data``."""
    pipe = mesh["pipe"].get_group()
    data = mesh["data"].get_group()

    def loss(x, y):
        xm = x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])
        ym = y.reshape((n_micro, y.shape[0] // n_micro) + y.shape[1:])
        out = pipeline_forward(stage_fn, xm, group=pipe, remat=remat)
        local = torch.stack([loss_fn(out[i], ym[i])
                             for i in range(n_micro)]).mean()
        return _DataMean.apply(local, data)

    return loss


def make_pipeline_train_step(stage, loss_fn: Callable, optimizer, mesh, *,
                             n_micro: int, remat: bool = False):
    """``step(x, y) -> loss``: one optimizer step of this rank's ``stage``
    (an ``nn.Module``) with ``optimizer`` (a ``torch.optim`` optimizer over
    its parameters). Each stage's gradient stays on its rank; only the sum
    over ``data`` is a collective."""
    pipe_loss = make_pipeline_loss_fn(stage, loss_fn, mesh, n_micro=n_micro,
                                      remat=remat)
    data = mesh["data"].get_group()

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = pipe_loss(x, y)
        loss.backward()
        grads = [p.grad for p in stage.parameters() if p.grad is not None]
        if grads and dist.get_world_size(data) > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=data)
            torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(
                torch.split(flat, [g.numel() for g in grads]), grads)])
        optimizer.step()
        return loss.detach()

    return step
