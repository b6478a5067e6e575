"""SAM interactive segmentation, LightSAM, the SAM distillation models and
SAM matting."""

from .sam import *  # noqa: F401,F403
from .light_sam import *  # noqa: F401,F403
from .sam_matting import *  # noqa: F401,F403
