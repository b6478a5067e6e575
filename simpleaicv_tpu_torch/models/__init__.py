"""Model zoo of the PyTorch port (importing it registers the models)."""

from . import backbones  # noqa: F401
from . import interactive_segmentation  # noqa: F401
