"""Backbone zoo (importing it registers the backbones)."""

from .resnet import *  # noqa: F401,F403
from .vit import *  # noqa: F401,F403
from .vit_moe import *  # noqa: F401,F403
from .resnetforcifar import *  # noqa: F401,F403
from .darknet import *  # noqa: F401,F403
from .convformer import *  # noqa: F401,F403
from .van import *  # noqa: F401,F403
