"""The serving layer's image codec without OpenCV (counterpart of
``_decode_image``, ``_png`` and ``_strip_multipart`` in ``demo/serve.py``).

``decode_image`` is ``data/image_io.py``'s, which the dataset readers
share: a request body decodes to what ``cv2.imdecode(..., IMREAD_COLOR)``
followed by ``COLOR_BGR2RGB`` gives (the EXIF orientation applied, grey,
palette and CMYK images converted as OpenCV converts them, alpha dropped,
16-bit samples cut to their high byte), equal on every value of the files
``tests/test_torch_image_io.py`` writes. Bytes that do not decode,
truncated files among them, raise ``ValueError``.

``encode_png`` is ``core/png.py``'s writer: the same pixels as
``cv2.imencode(".png", ...)``, other bytes (one IDAT chunk, filter 0).
"""

from __future__ import annotations

from ..core.png import encode_png
from ..data.image_io import decode_image

__all__ = ["decode_image", "encode_png", "strip_multipart"]


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
