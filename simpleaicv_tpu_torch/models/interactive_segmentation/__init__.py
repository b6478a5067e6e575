"""SAM interactive segmentation."""

from .sam import *  # noqa: F401,F403
