"""Detection models and decoders (importing the package registers them)."""

from .detr import *  # noqa: F401,F403
from .detr_decode import *  # noqa: F401,F403
from .dinodetr import *  # noqa: F401,F403
from .dinodetr_decode import *  # noqa: F401,F403
