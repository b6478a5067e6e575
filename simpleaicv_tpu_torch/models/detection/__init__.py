"""Detection models and decoders (importing the package registers them)."""

from .anchor import FCOSPositions, RetinaAnchors  # noqa: F401
from .retinanet import *  # noqa: F401,F403
from .fcos import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from .detr import *  # noqa: F401,F403
from .detr_decode import *  # noqa: F401,F403
from .dinodetr import *  # noqa: F401,F403
from .dinodetr_decode import *  # noqa: F401,F403
