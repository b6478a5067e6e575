"""Model zoo of the PyTorch port (importing it registers the models)."""

from . import backbones  # noqa: F401
from . import detection  # noqa: F401
from . import distillmodel  # noqa: F401
from . import face_detection  # noqa: F401
from . import interactive_segmentation  # noqa: F401
from . import pfan  # noqa: F401
from . import sapiens_parsing  # noqa: F401
from . import segmentation  # noqa: F401
from . import vit_mae  # noqa: F401
