"""Which device and which process (counterpart of
``simpleaicv_tpu/core/platform.py``).

The CLIs run on the card. ``SIMPLEAICV_PLATFORM=cpu``, the JAX CLIs' own
knob, runs them on the CPU instead; any other value raises. The process
index and count are torch.distributed's rank and world size, or 0 and 1
when it is not initialised.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def device_from_env() -> str:
    """``"cpu"`` under ``SIMPLEAICV_PLATFORM=cpu``, else ``"cuda"``."""
    plat = os.environ.get("SIMPLEAICV_PLATFORM", "")
    if plat not in ("", "cpu"):
        raise ValueError(f"SIMPLEAICV_PLATFORM={plat!r}: the port runs on "
                         f"the card (unset) or the CPU ('cpu')")
    return plat or "cuda"


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
