"""PyTorch port of simpleaicv_tpu for CUDA (Hopper) cards.

Imports torch and never jax; importing the package registers its models and
losses.
"""

from . import losses  # noqa: F401
from . import models  # noqa: F401
