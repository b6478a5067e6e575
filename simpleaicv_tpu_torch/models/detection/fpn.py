"""RetinaNet's feature pyramid (counterpart of
``simpleaicv_tpu/models/detection/fpn.py``) and its resize ``_upsample_to``,
which DeepLabV3+, PFAN and RetinaFace share.

``RetinaFPN``: P3-P5 from C3-C5 by 1x1 lateral convolutions, each coarser
level resized (align-corners bilinear) and added top-down, then a 3x3
convolution per level; P6 a 3x3 stride-2 convolution of P5 (``use_p5``,
FCOS) or of C5 (RetinaNet), P7 one of ReLU(P6). Every convolution has a
bias and computes in ``dtype`` from f32 parameters. NHWC; state-dict keys
are the JAX names (``P5_1``, ``P4_2``, ``P6``, ``P7``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.upsample import resize_bilinear
from ..common import Conv2d

__all__ = ["RetinaFPN", "_upsample_to"]


def _upsample_to(x, h: int, w: int):
    """Bilinear NHWC resize to (h, w) with ``align_corners=True`` (the
    reference's ``F.interpolate``), as matmuls; x itself when it already has
    that size."""
    if x.shape[1] == h and x.shape[2] == w:
        return x
    return resize_bilinear(x, (h, w), spatial_axes=(1, 2), align_corners=True)


class RetinaFPN(nn.Module):
    """(C3, C4, C5) -> [P3, P4, P5, P6, P7], ``planes`` channels each."""

    def __init__(self, in_channels: Sequence[int], planes: int = 256,
                 use_p5: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c3, c4, c5 = in_channels
        self.use_p5 = use_p5
        for level, c in ((3, c3), (4, c4), (5, c5)):
            self.add_module(f"P{level}_1", Conv2d(c, planes, 1, dtype=dtype))
            self.add_module(f"P{level}_2", Conv2d(planes, planes, 3,
                                                  padding=1, dtype=dtype))
        self.P6 = Conv2d(planes if use_p5 else c5, planes, 3, stride=2,
                         padding=1, dtype=dtype)
        self.P7 = Conv2d(planes, planes, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, inputs, train: bool = False):
        c3, c4, c5 = inputs
        p5 = self.P5_1(c5)
        p4 = self.P4_1(c4)
        p4 = _upsample_to(p5, p4.shape[1], p4.shape[2]) + p4
        p3 = self.P3_1(c3)
        p3 = _upsample_to(p4, p3.shape[1], p3.shape[2]) + p3

        p5 = self.P5_2(p5)
        p4 = self.P4_2(p4)
        p3 = self.P3_2(p3)

        p6 = self.P6(p5 if self.use_p5 else c5)
        p7 = self.P7(F.relu(p6))
        return [p3, p4, p5, p6, p7]
