"""Model zoo of the PyTorch port (importing it registers the models)."""

from . import interactive_segmentation  # noqa: F401
