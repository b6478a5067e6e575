"""A PNG writer for 8-bit grey and RGB images in numpy, with ``zlib`` and
``struct`` (no OpenCV): one IDAT chunk, filter type 0 on every row.
``read_png`` reads what ``write_png`` writes, so that a machine without
OpenCV can check the files."""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_png", "write_png", "read_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type (grey, RGB)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of a uint8 [H, W] grey or [H, W, 3] RGB image."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape[:2]
    c = 1 if image.ndim == 2 else image.shape[2]
    if image.ndim not in (2, 3) or c not in _COLOR_TYPES:
        raise ValueError(f"PNG of shape {image.shape}: expected [H, W] or "
                         f"[H, W, 3]")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          image.reshape(h, w * c)], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray):
    """Writes a uint8 [H, W, 3] RGB image to ``path``."""
    if image.ndim != 3:
        raise ValueError(f"write_png takes [H, W, 3], got {image.shape}")
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    """The uint8 [H, W, 3] image of an 8-bit RGB PNG file whose rows are
    all of filter type 0, as ``write_png`` writes them."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _SIGNATURE, "not a PNG file"
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and color == 2, (depth, color)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * 3 + 1)
    assert not rows[:, 0].any(), "rows filtered other than by type 0"
    return rows[:, 1:].reshape(h, w, 3).copy()
