"""PyTorch-checkpoint conversion by generic name rules (counterpart of
``simpleaicv_tpu/core/weight_convert.py``).

``convert_torch_checkpoint(path, model, name_map)`` reads a ``.pth`` state
dict, maps each name through ``name_map`` (``default_name_map`` without
one) to a name of the port's ``model`` (``None`` drops it), and loads what
matches by name and shape through ``core/checkpoint.py::
load_state_dict_partial`` (the position embedding resized where its token
count differs). The layouts stay torch's, which are the port's, so the JAX
function's kernel transposes (``torch_tensor_to_jax``) have no
counterpart here; the per-family converters are ``core/converters.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .checkpoint import load_state_dict_partial

__all__ = ["load_torch_state_dict", "convert_torch_checkpoint",
           "default_name_map"]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` file, from its ``state_dict``, ``model``
    or ``ema_model`` entry where it has one, on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "ema_model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return {k: v.detach() for k, v in sd.items() if hasattr(v, "detach")}


def default_name_map(torch_name: str) -> Optional[str]:
    """The name itself, but a BatchNorm's ``num_batches_tracked``, which no
    port model keeps (the JAX function's suffix renaming to flax's
    ``kernel``/``scale``/``mean``/``var`` is the port's identity)."""
    if torch_name.endswith("num_batches_tracked"):
        return None
    return torch_name


def convert_torch_checkpoint(path: str, model: torch.nn.Module,
                             name_map: Optional[Callable[[str],
                                                         Optional[str]]] = None):
    """Loads the checkpoint at ``path`` into ``model`` by ``name_map``;
    returns (model, the number of tensors loaded)."""
    name_map = name_map or default_name_map
    renamed = {}
    for k, v in load_torch_state_dict(path).items():
        target = name_map(k)
        if target is not None:
            renamed[target] = v
    tensors, n = load_state_dict_partial(renamed, model.state_dict())
    model.load_state_dict(tensors)
    return model, n
