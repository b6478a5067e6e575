"""The train/eval engine (counterpart of ``simpleaicv_tpu/core/engine.py``).

Per-task behaviour comes in as a ``loss_fn``; everything else is shared:
gradient accumulation over micro-batches, value and norm clipping, skipping
of non-finite batches, the optimizer update, EMA.

In a world of W ranks (``torch.distributed``, one card each) each rank
takes its rows of the global batch (``data.loader.rank_indices``) and a
step computes the JAX engine's step on the W-device mesh, one global-batch
step: BatchNorm statistics are the global micro-batch's
(``ops.fused_bn``); after the micro-batch loop the gradients are averaged
over the ranks with one ``all_reduce`` per dtype (FSDP2's sharded
gradients come averaged from its own reduce-scatter, and an expert
parameter's from its replicas' group, ``parallel.moe``); the metrics are
averaged in the same collective that counts the ranks with a non-finite
loss or gradient, so every rank skips together, and the host reads one
number a step. No ``DistributedDataParallel``: its hooks would reduce on
every micro-batch.

The state lives on the card: ``create_train_state`` and ``make_eval_step``
take ``device="cuda"`` and raise when there is no card; pass
``device="cpu"`` to stay on the CPU. A step raises on a model or a batch
that lies elsewhere, and never moves to the CPU on its own.

Against the JAX engine's pure, jitted step, the step here runs eagerly and
updates the model, the optimizer and the EMA parameters of its ``TrainState``
in place, returning the same object. The semantics are the JAX engine's:

* the global batch is split on its leading dim into ``accumulation_steps``
  micro-batches; gradients are summed in f32 and divided by the count, and
  metrics are averaged;
* clipping by value comes before clipping by global norm;
* on a non-finite loss or gradient the parameters, the optimizer state
  (its step count included, so the schedule does not move) and the model's
  buffers stay as they were; PyTorch updates BatchNorm statistics during the
  forward, so the buffers are put back from a copy. EMA still updates, and
  ``metrics["skipped"]`` is 1;
* ``TrainState.step`` always advances; it only seeds the step's generator,
  with the rank, so that ranks draw different dropout and drop-path masks
  (rank 0 draws what one process draws).

The finiteness decision is read on the host (one ``.item()`` per step) and
the update is then launched or not; the schedule is evaluated on the host
from the optimizer's step count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.common import resolve_device
from ..parallel.mesh import local, rank, world_size
from .ema import ema_init, ema_update
from .optim import Optimizer, clip_by_value_, global_norm

# loss_fn(model, batch, generator, train) -> (loss: f32 scalar, metrics: dict)
LossFn = Callable[..., Any]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]  # None when EMA disabled
    device: torch.device  # where the model, the moments and the EMA lie


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    accumulation_steps: int = 1
    use_ema: bool = False
    ema_decay: float = 0.9999
    skip_non_finite: bool = True
    # gradient clipping: by value, then by global norm. 0 disables.
    clip_grad_value: float = 0.0
    clip_max_norm: float = 0.0


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       cfg: EngineConfig, device="cuda") -> TrainState:
    """The state of a run on ``device``: the model and the optimizer's
    moments are moved there, in place, before the EMA copy is taken. Raises
    when ``device`` is CUDA and there is no card."""
    device = resolve_device(device)
    model.to(device)
    optimizer.to(device, model)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema_params=ema_init(model) if cfg.use_ema else None,
                      device=optimizer.params[0].device)


def _require_on(device, model, batch):
    """Raises unless ``model``'s parameters and ``batch``'s tensors lie on
    ``device``, so that no step runs quietly on another device than the one
    its caller named. A ``None`` entry of the batch (a prompt kind not
    chosen) lies nowhere and passes."""
    found = {f"batch[{k!r}]": v.device for k, v in batch.items()
             if v is not None}
    p = next(model.parameters(), None)
    if p is not None:
        found["the model"] = p.device
    for what, d in found.items():
        if d.type != device.type or (device.index is not None
                                     and d.index != device.index):
            raise ValueError(f"{what} lies on {d}, the step runs on {device}")


def step_generator(generator: torch.Generator, seed: int, step: int,
                   rank: int = 0):
    """Seeds ``generator`` for one step from (seed, step, rank): the port's
    stand-in for ``fold_in(rng, step)``. It gives other numbers than JAX's;
    rank 0 gets the numbers of a run without ranks."""
    mask = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + step) & mask
    if rank:
        x = ((x ^ (x >> 33)) * 0xFF51AFD7ED558CCD + rank) & mask
    x = ((x ^ (x >> 31)) * 0xBF58476D1CE4E5B9) & mask
    # mixed so that the low 32 bits, all a CPU generator keeps of a seed,
    # depend on both numbers
    generator.manual_seed((x ^ (x >> 29)) & (mask >> 1))
    return generator


def _micro_batches(batch, accum):
    if accum == 1:
        return [batch]
    # a None entry stays None in every micro-batch
    split = {k: None if v is None else
             v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
             for k, v in batch.items()}
    return [{k: None if v is None else v[i] for k, v in split.items()}
            for i in range(accum)]


def _sync_group(p):
    """The ranks whose gradients of ``p`` the engine averages: None (the
    world) for a replicated parameter, the replicas' group for an expert
    shard (``parallel.moe.shard_experts``)."""
    return getattr(p, "_sync_group", None)


def average_gradients(params, grads, accum: int):
    """Divides ``grads`` by ``accum`` and, in a world of W ranks, makes each
    the mean over the ranks of the global batch: one ``all_reduce`` per
    group and dtype over the flattened unsharded gradients, divided by W
    with the micro-batch count. An FSDP2 gradient (sharded) arrives
    averaged and is only divided by ``accum``."""
    world = world_size()
    if world == 1:
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        return
    buckets: Dict[Any, list] = {}
    sharded = []
    for p, g in zip(params, grads):
        if g is not local(g):
            sharded.append(local(g))
        else:
            buckets.setdefault((id(_sync_group(p)), g.dtype), []).append(
                (p, g))
    for members in buckets.values():
        group = _sync_group(members[0][0])
        flat = torch.cat([g.reshape(-1) for _, g in members])
        dist.all_reduce(flat, group=group)
        flat /= float(world * accum)
        grads_in = [g for _, g in members]
        torch._foreach_copy_(grads_in, [c.view_as(g) for c, g in zip(
            torch.split(flat, [g.numel() for g in grads_in]), grads_in)])
    if sharded and accum > 1:
        torch._foreach_div_(sharded, float(accum))


def make_train_step(loss_fn: LossFn, cfg: EngineConfig, augment_fn=None):
    """Builds the train step ``(state, batch, seed=0) -> (state, metrics)``.

    ``batch`` is a dict of tensors with a leading global-batch dim, on the
    state's device (an entry may be ``None`` and stays so); the step raises
    for a batch or a model elsewhere. ``augment_fn(batch, generator) ->
    batch`` is a hook for device-side augmentation of the global batch
    before the micro-batch split. Metrics are 0-d tensors on the device, ``skipped`` included.
    """
    accum = max(cfg.accumulation_steps, 1)

    def step_fn(state: TrainState, batch, seed: int = 0):
        model, opt = state.model, state.optimizer
        params, device = opt.params, state.device
        _require_on(device, model, batch)
        generator = step_generator(torch.Generator(device=device), seed,
                                   state.step, rank())
        model.train()
        if augment_fn is not None:
            batch = augment_fn(batch, generator)
        buffers = list(model.buffers())
        saved = [b.clone() for b in buffers] if cfg.skip_non_finite else []

        for p in params:
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        for micro in _micro_batches(batch, accum):
            loss, metrics = loss_fn(model, micro, generator, True)
            loss.backward()
            for key, val in {**metrics, "loss": loss}.items():
                val = torch.as_tensor(val, device=device).detach().float()
                sums[key] = sums[key] + val if key in sums else val
        metrics = {k: v / accum for k, v in sums.items()}
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]

        with torch.no_grad():
            average_gradients(params, grads, accum)
            if cfg.clip_grad_value and cfg.clip_grad_value > 0:
                clip_by_value_(grads, cfg.clip_grad_value)
            if cfg.clip_max_norm and cfg.clip_max_norm > 0:
                scale = torch.clamp(
                    cfg.clip_max_norm / global_norm(grads).clamp(min=1e-12),
                    max=1.0)
                torch._foreach_mul_([local(g) for g in grads], scale)

            ok = True
            bad = None
            if cfg.skip_non_finite:
                # a tensor's largest |value| is finite iff all of it is
                peaks = list(torch._foreach_norm([local(g) for g in grads],
                                                 float("inf")))
                bad = (~torch.isfinite(torch.stack(
                    peaks + [metrics["loss"]])).all()).float()
            if world_size() > 1:
                # one collective: the metrics' sums and the count of ranks
                # that saw a non-finite value
                keys = list(metrics)
                vec = torch.stack([metrics[k] for k in keys]
                                  + ([bad] if bad is not None else []))
                dist.all_reduce(vec)
                metrics = {k: vec[i] / world_size()
                           for i, k in enumerate(keys)}
                if bad is not None:
                    bad = vec[-1]
            if bad is not None:
                ok = not bool(bad.item())
            if ok:
                opt.step(grads)
            else:
                for b, old in zip(buffers, saved):
                    b.copy_(old)
            if state.ema_params is not None:
                ema_update(state.ema_params, model, cfg.ema_decay)
        for p in params:
            p.grad = None

        metrics["skipped"] = torch.tensor(0.0 if ok else 1.0, device=device)
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(eval_fn: LossFn, device="cuda"):
    """``eval_fn(model, batch, generator, train=False) -> metrics dict``,
    run in eval mode without gradients on ``device``. Raises when ``device``
    is CUDA and there is no card; the step raises for a model or a batch
    that lies elsewhere."""
    device = resolve_device(device)

    @torch.no_grad()
    def step_fn(model, batch, generator=None):
        _require_on(device, model, batch)
        model.eval()
        return eval_fn(model, batch, generator, False)

    return step_fn
