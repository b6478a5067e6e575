"""Exponential moving average of parameters (counterpart of
``simpleaicv_tpu/core/ema.py``): per step
``ema = decay * ema + (1 - decay) * params`` with default decay 0.9999. The
EMA parameters are a dict keyed like ``model.named_parameters()``, so
``model.load_state_dict(ema, strict=False)`` evaluates with them. A
parameter sharded by FSDP2 keeps a sharded EMA, updated through this
rank's slice.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import local


def ema_init(model):
    """A detached copy of ``model``'s parameters."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema_params, model, decay: float = 0.9999):
    """Updates ``ema_params`` in place from ``model``'s parameters. The decay
    is rounded to f32 first, as the JAX package holds it."""
    d = torch.tensor(decay, dtype=torch.float32).item()
    params = dict(model.named_parameters())
    ema = [local(ema_params[name]) for name in params]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, [local(p.detach()) for p in params.values()],
                        alpha=1.0 - d)
    return ema_params
