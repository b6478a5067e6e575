"""Backbone zoo (importing it registers the backbones)."""

from .resnet import *  # noqa: F401,F403
from .vit import *  # noqa: F401,F403
