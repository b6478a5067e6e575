"""Operators of the PyTorch port; hand kernels live in csrc/.

Importing this package registers the hand kernels as ``torch.library``
operators (``torch.ops.simpleaicv.*``), which a saved ``torch.export``
program needs before ``torch.export.load``."""

from . import flash_attention, msda  # noqa: F401
