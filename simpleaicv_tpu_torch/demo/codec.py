"""The serving layer's image codec without OpenCV (counterpart of
``_decode_image``, ``_png`` and ``_strip_multipart`` in ``demo/serve.py``).

``decode_image`` decodes a request body with PIL, one route for JPEG, PNG
and the other formats PIL reads, and gives what ``cv2.imdecode(...,
IMREAD_COLOR)`` followed by ``COLOR_BGR2RGB`` gives:
  * the EXIF orientation applied (``ImageOps.exif_transpose``);
  * grey, bilevel and palette images expanded to three channels;
  * an alpha channel dropped, not composited;
  * 16-bit samples cut to their high byte, as libpng's ``strip_16`` does.
JPEGs decode through PIL's libjpeg, whose IDCT and chroma upsampling may
round otherwise than the libjpeg-turbo OpenCV links: a few values part by
a level or two (``tests/test_torch_serve.py`` bounds the share). Bytes that
do not decode, truncated files among them, raise ``ValueError``.

``encode_png`` is ``core/png.py``'s writer: the same pixels as
``cv2.imencode(".png", ...)``, other bytes (one IDAT chunk, filter 0).
"""

from __future__ import annotations

import io

import numpy as np
from PIL import Image, ImageOps

from ..core.png import encode_png

__all__ = ["decode_image", "encode_png", "strip_multipart"]


def _rgb_array(img: Image.Image) -> np.ndarray:
    if img.mode in ("I;16", "I;16B", "I;16L", "I"):
        grey = (np.asarray(img).astype(np.uint32) >> 8).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.array(img, np.uint8)


def decode_image(body: bytes) -> np.ndarray:
    """Request body (JPEG, PNG, ...) -> uint8 [H, W, 3] RGB image."""
    try:
        with Image.open(io.BytesIO(body)) as img:
            img.load()
            return _rgb_array(ImageOps.exif_transpose(img))
    except (OSError, SyntaxError, ValueError, EOFError,
            Image.DecompressionBombError) as e:
        raise ValueError("request body is not a decodable image") from e


def strip_multipart(body: bytes, content_type) -> bytes:
    """The first file part of a multipart/form-data body; any other body
    as it is."""
    if "multipart/form-data" not in (content_type or ""):
        return body
    boundary = content_type.split("boundary=")[-1].strip().strip('"').encode()
    for part in body.split(b"--" + boundary):
        idx = part.find(b"\r\n\r\n")
        if idx < 0:
            continue
        head, payload = part[:idx], part[idx + 4:]
        if b"filename=" in head:
            return payload.rstrip(b"\r\n")
    raise ValueError("no file part in multipart body")
