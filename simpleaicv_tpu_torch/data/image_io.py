"""Image decoding without OpenCV, shared by the dataset readers and the
server (``demo/codec.py`` re-exports it): the counterpart of
``cv2.imread`` / ``cv2.imdecode`` with ``IMREAD_COLOR`` (then
``COLOR_BGR2RGB``) and with ``IMREAD_GRAYSCALE``.

``decode_image`` gives OpenCV's colour pixels through PIL:
  * the EXIF orientation applied (``ImageOps.exif_transpose``);
  * grey, bilevel and palette images expanded to three channels;
  * an alpha channel dropped, not composited;
  * 16-bit samples cut to their high byte, as libpng's ``strip_16`` does;
  * a CMYK JPEG as OpenCV converts it: libjpeg hands over the inverted
    samples c' = 255 - c, k' = 255 - k of PIL's, and each channel is
    k' - ((255 - c') * k' >> 8).

``decode_grey`` gives OpenCV's grey pixels:
  * a PNG through libpng's own ``rgb_to_gray`` (OpenCV sets it, it does
    not call ``cvtColor``): a grey PNG as it is, LA its L, 16-bit grey
    its high byte, RGB, RGBA and palette images (with or without
    ``tRNS``) expanded to RGB with the alpha dropped, then
    (9797 R + 19234 G + 3737 B) >> 15;
  * a JPEG through libjpeg's own grey output (PIL's ``draft("L")``), a
    CMYK JPEG converted as above and then weighed as OpenCV's
    ``icvCvt_CMYK2Gray`` does, (4899 R + 9617 G + 1868 B + 8192) >> 14;
  * a WebP decoded to colour and weighed as ``cvtColor`` does,
    (9798 R + 19235 G + 3735 B + 16384) >> 15; BMP, TIFF and GIF as
    ``icvCvt_BGR2Gray``, with the weights of the CMYK JPEG.

``tests/test_torch_image_io.py`` holds both against OpenCV on this
machine's files: equal on every value of grey, LA, bilevel, 16-bit grey,
RGB, RGBA and palette PNGs (with and without ``tRNS``), and of colour,
grey and CMYK JPEGs at several qualities and chroma samplings, and of
BMP, TIFF, GIF and lossless WebP files. Where they part: a 16-bit colour
PNG's grey, which libpng weighs before it cuts the samples to 8 bits
while PIL gives only their high bytes (one level on about half the
pixels); and a JPEG's IDCT may round otherwise under another libjpeg
build than the one PIL and OpenCV share here.

``read_image`` and ``read_grey`` read a file; where ``cv2.imread`` would
return None (no such file, bytes that do not decode) they raise
``ValueError`` naming it.

``encode_image`` and ``write_image`` are the counterparts of
``cv2.imencode`` and ``cv2.imwrite`` for the two formats the dataset
preparation writes, taking RGB where OpenCV takes BGR:
  * ``.jpg``/``.jpeg`` through PIL at OpenCV's defaults (quality 95, no
    optimisation, baseline, a colour image's chroma at 4:2:0, a grey
    image as one component): the same bytes as ``cv2.imencode`` where PIL
    and OpenCV share a libjpeg build, as they do on this repository's test
    machine;
  * ``.png`` through ``core/png.py``: other bytes than OpenCV's (another
    compressor), the same pixels.
"""

from __future__ import annotations

import io
import os

import numpy as np
from PIL import Image, ImageOps

from ..core.png import encode_png

__all__ = ["decode_image", "decode_grey", "read_image", "read_grey",
           "encode_image", "write_image"]

_ERRORS = (OSError, SyntaxError, ValueError, EOFError,
           Image.DecompressionBombError)
_WIDE_GREY = ("I;16", "I;16B", "I;16L", "I")


def _cmyk_to_rgb(img: Image.Image) -> np.ndarray:
    """OpenCV's ``icvCvt_CMYK2BGR`` on libjpeg's samples, in RGB order."""
    cmyk = np.asarray(img, np.int32)
    k = 255 - cmyk[..., 3:]
    # libjpeg's c' is 255 - c, so 255 - c' is PIL's c
    return (k - ((cmyk[..., :3] * k) >> 8)).astype(np.uint8)


def _rgb_array(img: Image.Image) -> np.ndarray:
    if img.mode in _WIDE_GREY:
        grey = (np.asarray(img).astype(np.uint32) >> 8).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    if img.mode == "CMYK":
        return _cmyk_to_rgb(img)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.array(img, np.uint8)


def _weigh(rgb: np.ndarray, weights, shift: int, rounding: int) -> np.ndarray:
    rgb = rgb.astype(np.int32)
    return ((rgb[..., 0] * weights[0] + rgb[..., 1] * weights[1]
             + rgb[..., 2] * weights[2] + rounding) >> shift).astype(np.uint8)


def _png_grey(img: Image.Image) -> np.ndarray:
    if img.mode in _WIDE_GREY:
        return (np.asarray(img).astype(np.uint32) >> 8).astype(np.uint8)
    if img.mode in ("L", "1"):
        return np.array(img.convert("L"), np.uint8)
    if img.mode == "LA":
        return np.array(img, np.uint8)[..., 0].copy()
    rgb = np.array(img.convert("RGB"), np.uint8)
    # libpng: rgb_to_gray with OpenCV's 0.299 / 0.587 in 15-bit fixed point
    return _weigh(rgb, (9797, 19234, 3737), 15, 0)


def _opencv_grey(rgb: np.ndarray) -> np.ndarray:
    return _weigh(rgb, (4899, 9617, 1868), 14, 1 << 13)


def _grey(img: Image.Image) -> np.ndarray:
    png, webp = img.format == "PNG", img.format == "WEBP"
    if img.format == "JPEG" and img.mode != "CMYK":
        img.draft("L", img.size)  # libjpeg's own Y output, no DCT scale
    img.load()
    img = ImageOps.exif_transpose(img)
    if png:
        return _png_grey(img)
    if img.mode in ("L", "1"):
        return np.array(img.convert("L"), np.uint8)
    if webp:  # decoded to BGR, then cvtColor
        return _weigh(_rgb_array(img), (9798, 19235, 3735), 15, 1 << 14)
    return _opencv_grey(_rgb_array(img))


def _open(body: bytes, what: str, convert):
    try:
        with Image.open(io.BytesIO(body)) as img:
            return convert(img)
    except _ERRORS as e:
        raise ValueError(f"{what} is not a decodable image") from e


def _colour(img: Image.Image) -> np.ndarray:
    img.load()
    return _rgb_array(ImageOps.exif_transpose(img))


def decode_image(body: bytes, what: str = "request body") -> np.ndarray:
    """Encoded bytes (JPEG, PNG, ...) -> uint8 [H, W, 3] RGB image."""
    return _open(body, what, _colour)


def decode_grey(body: bytes, what: str = "request body") -> np.ndarray:
    """Encoded bytes -> uint8 [H, W] grey image (``IMREAD_GRAYSCALE``)."""
    return _open(body, what, _grey)


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise ValueError(f"{path}: cannot read the file ({e})") from None


def read_image(path: str) -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W, 3] RGB."""
    return decode_image(_read(path), path)


def read_grey(path: str) -> np.ndarray:
    """The image file at ``path`` as uint8 [H, W] grey."""
    return decode_grey(_read(path), path)


def encode_image(ext: str, image: np.ndarray) -> bytes:
    """The ``ext`` (``.jpg``, ``.jpeg`` or ``.png``) file of a uint8
    [H, W] grey or [H, W, 3] RGB image."""
    image = np.ascontiguousarray(image, np.uint8)
    ext = ext.lower()
    if ext == ".png":
        return encode_png(image)
    if ext not in (".jpg", ".jpeg"):
        raise ValueError(f"cannot encode {ext!r}: only .jpg and .png")
    out = io.BytesIO()
    colour = {"subsampling": 2} if image.ndim == 3 else {}
    Image.fromarray(image).save(out, format="JPEG", quality=95, **colour)
    return out.getvalue()


def write_image(path: str, image: np.ndarray):
    """Writes a uint8 [H, W] grey or [H, W, 3] RGB image to ``path`` in the
    format its extension names (``.jpg`` without one)."""
    body = encode_image(os.path.splitext(path)[1] or ".jpg", image)
    with open(path, "wb") as f:
        f.write(body)
