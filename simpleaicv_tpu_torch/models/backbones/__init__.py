"""Backbone zoo (importing it registers the backbones)."""

from .vit import *  # noqa: F401,F403
