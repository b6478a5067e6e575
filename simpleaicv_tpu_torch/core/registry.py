"""Factory registries (a copy of simpleaicv_tpu/core/registry.py, so the
port resolves models by the same names).

The reference uses ``module.__dict__[name](**kwargs)`` as its registry
(reference: simpleAICV/classification/backbones/__init__.py:1-6). We keep that
call surface (`create('resnet50', num_classes=1000)`) but back it with explicit
named registries so tasks can introspect / enumerate the zoo.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from .config import MissingCounterpartError


class Registry:
    """A name -> factory mapping with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str | None = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._factories:
                raise KeyError(f"duplicate {self.kind} factory: {key}")
            self._factories[key] = fn
            return fn

        return deco

    def create(self, key: str, **kwargs):
        """Builds ``key``; a name the JAX package registers but the port
        has not ported raises ``MissingCounterpartError`` naming it."""
        if key not in self._factories:
            raise MissingCounterpartError(
                f"{self.kind} '{key}' has no counterpart in the PyTorch port. "
                f"known: {sorted(self._factories)}")
        return self._factories[key](**kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._factories

    def names(self):
        return sorted(self._factories)


BACKBONES = Registry("backbone")
MODELS = Registry("model")
LOSSES = Registry("loss")
DECODERS = Registry("decoder")
DATASETS = Registry("dataset")
TRANSFORMS = Registry("transform")
