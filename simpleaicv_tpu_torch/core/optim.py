"""Optimizer builder with the reference's parameter-group semantics
(counterpart of ``simpleaicv_tpu/core/optim.py``).

* SGD (momentum / Nesterov, weight decay folded into the gradient before
  the momentum buffer) and AdamW (decoupled decay, scaled by the same
  per-leaf lr as the Adam update);
* ``global_weight_decay=False``: no decay for parameters with at most one
  dimension and for names matching ``no_weight_decay_layer_name_list``;
* per-sublayer lr / weight-decay overrides by name substring;
* ViT layer-wise lr decay: embedding-like parameters get the deepest decay,
  transformer block *i* gets ``decay**(num_blocks - i)``;
* the schedule's shape is applied to each leaf's own initial lr: a leaf's
  rate is the schedule evaluated at ``lr * scale``, which with a warm-up or
  a ``min_lr`` floor is not ``scale`` times the base rate, so param groups
  under a ``LambdaLR`` would give other numbers;
* a frozen leaf's update is exactly zero.

Name lists are written for the JAX package's parameter paths
(``blocks_3/attn/qkv/kernel``). The port's parameter names are rewritten to
that form (``blocks.3.attn.qkv.weight`` -> ``blocks_3/attn/qkv/weight``)
before matching, so the same lists select the same parameters.

The update runs as multi-tensor (``torch._foreach``) operations on f32
parameters, in place. The step count that the schedule and Adam's bias
correction read lives in the optimizer and advances only when ``step`` is
called, so a skipped batch leaves it alone.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from ..models.common import resolve_device
from .schedule import SchedulerConfig, lr_at_epoch
from .weights import path_form


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "SGD"  # SGD | AdamW
    lr: float = 0.1
    weight_decay: float = 1e-4
    global_weight_decay: bool = False
    no_weight_decay_layer_name_list: Tuple[str, ...] = ()
    sub_layer_lr: Optional[Mapping[str, float]] = None
    sub_layer_weight_decay: Optional[Mapping[str, float]] = None
    # SGD
    momentum: float = 0.9
    nesterov: bool = False
    # AdamW
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # ViT layer-wise lr decay
    lr_layer_decay: Optional[float] = None
    lr_layer_decay_block_nums: Optional[int] = None
    block_name: Optional[str] = None  # substring of block parameters' names
    # grad clipping, applied before the update
    clip_grad_value: Optional[float] = None
    clip_max_norm: Optional[float] = None
    # hard-freeze by name substring: the update is forced to exactly zero
    # (a per-leaf lr of 0 is not enough under a schedule with a min_lr floor)
    frozen_layer_name_list: Tuple[str, ...] = ()


_EMBED_SCALE0_NAMES = ("position_encoding", "cls_token", "patch_embedding")
_BLOCK_IDX_RE = re.compile(r"_(\d+)(?:/|$)")


def per_leaf_hyperparams(cfg: OptimizerConfig, model: nn.Module):
    """Returns (lr_scales, weight_decays, table): two lists of Python floats
    in ``model.named_parameters()`` order, ``lr_scale`` relative to
    ``cfg.lr``, and ``table``, a list of (name, lr, lr_scale, wd) rows for
    start-up logging."""
    layer_scales = None
    if cfg.lr_layer_decay is not None:
        if cfg.lr_layer_decay_block_nums is None or not cfg.block_name:
            raise ValueError("lr_layer_decay needs lr_layer_decay_block_nums "
                             "and block_name")
        num_layers = cfg.lr_layer_decay_block_nums + 1
        layer_scales = [
            cfg.lr_layer_decay**(num_layers - i) for i in range(num_layers + 1)
        ]

    lr_scales, wds, table = [], [], []
    for port_name, leaf in model.named_parameters():
        name = path_form(port_name)
        # weight decay
        if cfg.global_weight_decay:
            wd = cfg.weight_decay
        elif leaf.dim() <= 1 or any(
                s in name for s in cfg.no_weight_decay_layer_name_list):
            wd = 0.0
        else:
            wd = cfg.weight_decay
            if cfg.sub_layer_weight_decay:
                for prefix, sub_wd in cfg.sub_layer_weight_decay.items():
                    if prefix in name:
                        wd = float(sub_wd)
                        break
        # per-sublayer lr override
        leaf_lr = cfg.lr
        if cfg.sub_layer_lr:
            for prefix, sub_lr in cfg.sub_layer_lr.items():
                if prefix in name:
                    leaf_lr = float(sub_lr)
                    break
        # ViT layer-wise decay
        scale = 1.0
        if layer_scales is not None:
            if cfg.block_name in name:
                m = _BLOCK_IDX_RE.search(name)
                layer_id = int(m.group(1)) if m else 0
                layer_id = min(layer_id, cfg.lr_layer_decay_block_nums - 1)
                scale = layer_scales[layer_id + 1]
            elif any(s in name for s in _EMBED_SCALE0_NAMES):
                scale = layer_scales[0]

        frozen = any(s in name for s in cfg.frozen_layer_name_list)
        if frozen:
            wd = 0.0
        lr_scales.append(0.0 if frozen else leaf_lr / cfg.lr * scale)
        wds.append(wd)
        table.append((port_name, 0.0 if frozen else leaf_lr, scale, wd))
    return lr_scales, wds, table


class Optimizer:
    """SGD or AdamW over ``model``'s parameters with per-leaf rates.

    ``step(grads)`` takes one f32 gradient per parameter, in
    ``model.named_parameters()`` order, and updates the parameters in place.
    ``moments`` holds the state: ``trace`` for SGD with momentum, ``mu`` and
    ``nu`` for AdamW, each a list in the same order.
    """

    def __init__(self, cfg: OptimizerConfig, sched: SchedulerConfig,
                 steps_per_epoch: int, model: nn.Module):
        if cfg.name not in ("SGD", "AdamW"):
            raise ValueError(f"Unsupported optimizer {cfg.name!r}")
        self.cfg, self.sched = cfg, sched
        self.steps_per_epoch = steps_per_epoch
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.lr_scales, self.wds, self.table = per_leaf_hyperparams(cfg, model)
        self.step_count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        if cfg.name == "AdamW":
            self.moments = {"mu": zeros(), "nu": zeros()}
        elif cfg.momentum:
            self.moments = {"trace": zeros()}
        else:
            self.moments = {}
        self._decayed = [i for i, wd in enumerate(self.wds) if wd != 0.0]
        self._live = [i for i, s in enumerate(self.lr_scales) if s != 0.0]

    def to(self, device, model: nn.Module):
        """Follows ``model`` to ``device``: moves the moments there and
        takes hold of the model's parameters again, which ``nn.Module.to``
        replaces for some devices."""
        named = list(model.named_parameters())
        if [n for n, _ in named] != self.names:
            raise ValueError("not the model this optimizer was built for")
        self.params = [p for _, p in named]
        self.moments = {key: [t.to(device) for t in tensors]
                        for key, tensors in self.moments.items()}
        return self

    def leaf_lrs(self, step: Optional[int] = None):
        """Each parameter's lr at ``step`` (default: the next update's): the
        schedule applied to that leaf's own initial lr."""
        step = self.step_count if step is None else step
        frac_epoch = float(step) / float(max(self.steps_per_epoch, 1))
        by_scale = {}
        for s in self.lr_scales:
            if s not in by_scale:
                leaf = dataclasses.replace(self.sched, lr=self.sched.lr * s)
                by_scale[s] = lr_at_epoch(leaf, frac_epoch)
        return [by_scale[s] for s in self.lr_scales]

    def _pick(self, tensors, index):
        return [tensors[i] for i in index]

    @torch.no_grad()
    def step(self, grads):
        cfg = self.cfg
        grads = list(grads)
        if cfg.clip_grad_value is not None:
            clip_by_value_(grads, float(cfg.clip_grad_value))
        if cfg.clip_max_norm is not None:
            norm = global_norm(grads)
            max_norm = float(cfg.clip_max_norm)
            torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                                   max_norm / norm))
        decayed = self._pick(self.params, self._decayed)
        decays = self._pick(self.wds, self._decayed)

        if cfg.name == "SGD":
            # weight decay joins the gradient before the momentum buffer
            if decayed:
                torch._foreach_add_(self._pick(grads, self._decayed),
                                    torch._foreach_mul(decayed, decays))
            updates = grads
            if cfg.momentum:
                trace = self.moments["trace"]
                torch._foreach_mul_(trace, cfg.momentum)
                torch._foreach_add_(trace, grads)
                updates = trace
                if cfg.nesterov:
                    updates = torch._foreach_add(grads, trace,
                                                 alpha=cfg.momentum)
        else:
            mu, nu = self.moments["mu"], self.moments["nu"]
            torch._foreach_mul_(mu, cfg.beta1)
            torch._foreach_add_(mu, grads, alpha=1.0 - cfg.beta1)
            torch._foreach_mul_(nu, cfg.beta2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - cfg.beta2)
            count = self.step_count + 1
            bias1 = 1.0 - cfg.beta1**count
            bias2 = 1.0 - cfg.beta2**count
            denom = torch._foreach_sqrt(nu)
            torch._foreach_div_(denom, math.sqrt(bias2))
            torch._foreach_add_(denom, cfg.eps)
            updates = torch._foreach_div(mu, denom)
            torch._foreach_div_(updates, bias1)
            # decoupled decay joins the update, under the same per-leaf lr
            if decayed:
                torch._foreach_add_(self._pick(updates, self._decayed),
                                    torch._foreach_mul(decayed, decays))

        lrs = self.leaf_lrs()
        torch._foreach_add_(
            self._pick(self.params, self._live),
            torch._foreach_mul(self._pick(updates, self._live),
                               [-lrs[i] for i in self._live]))
        self.step_count += 1


def clip_by_value_(tensors, value: float):
    """Clamps every element of ``tensors`` to [-value, value], in place."""
    torch._foreach_clamp_max_(tensors, value)
    torch._foreach_clamp_min_(tensors, -value)


def global_norm(tensors):
    """The 2-norm of all of ``tensors`` taken as one vector, a 0-d tensor."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


def build_optimizer(cfg: OptimizerConfig, sched: SchedulerConfig,
                    steps_per_epoch: int, model: nn.Module, device="cuda"):
    """Builds the optimizer on ``device``: the model is moved there first, in
    place, so that the moments are allocated beside the parameters. Raises
    when ``device`` is CUDA and there is no card. Returns (optimizer,
    group_table)."""
    model.to(resolve_device(device))
    opt = Optimizer(cfg, sched, steps_per_epoch, model)
    return opt, opt.table


def current_lr(cfg: OptimizerConfig, sched: SchedulerConfig,
               steps_per_epoch: int, step: int) -> float:
    """Base-group LR at a given step, for logging."""
    return lr_at_epoch(sched, float(step) / float(max(steps_per_epoch, 1)))
