"""Semantic-segmentation models (importing the package registers them)."""

from .deeplabv3plus import *  # noqa: F401,F403
