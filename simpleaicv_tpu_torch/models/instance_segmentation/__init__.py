"""Instance-segmentation models and decoders (importing the package
registers them)."""

from .solov2 import *  # noqa: F401,F403
from .yolact import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
