"""Detection models (importing the package registers them)."""

from .dinodetr import *  # noqa: F401,F403
