"""The FPN's resize (counterpart of ``_upsample_to`` in
``simpleaicv_tpu/models/detection/fpn.py``), shared by DeepLabV3+ and PFAN.
``RetinaFPN`` is not ported yet."""

from __future__ import annotations

from ...ops.upsample import resize_bilinear

__all__ = ["_upsample_to"]


def _upsample_to(x, h: int, w: int):
    """Bilinear NHWC resize to (h, w) with ``align_corners=True`` (the
    reference's ``F.interpolate``), as matmuls; x itself when it already has
    that size."""
    if x.shape[1] == h and x.shape[2] == w:
        return x
    return resize_bilinear(x, (h, w), spatial_axes=(1, 2), align_corners=True)
