"""ctypes bindings for the port's host libraries (counterpart of
``simpleaicv_tpu/data/native_io.py``; sources in ``data/csrc``, built by
``data/host_build.py`` at first use).

* ``gather_records``: the packed loader's gather of fixed-stride records
  (``gather`` library, the C++ runtime only). ``gather_records_plain`` is
  its plain numpy version, which the tests hold it against.
* ``decode_image``, ``decode_resize``, ``batch_decode_files_u8``: libjpeg
  decodes (``jpeg`` library, ``-ljpeg``): at full size (the readers), or
  DCT-scaled and resized bilinearly to (H, W) by a stretch or a letterbox
  (the readers' ``native_decode_hw``; the pack writer's uint8 batches).
  The JAX bindings' f32 batch and uint8 single decodes have no caller in
  the port and are not kept.

Against the JAX package: a library that is missing or fails to build
raises, where the JAX bindings return None and their callers fall back to
numpy or cv2. A single decode that fails raises ``ValueError``. A batch
decode keeps the JAX semantics: a file that does not read or decode leaves
its slot pad-filled, with a warning and the count.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Optional, Sequence

import numpy as np

from . import host_build

__all__ = ["gather_records", "gather_records_plain", "decode_image",
           "decode_resize", "batch_decode_files_u8"]

_C_LONG_P = ctypes.POINTER(ctypes.c_long)
_U8_P = ctypes.POINTER(ctypes.c_uint8)
_F32_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)


def _gather_lib():
    lib = host_build.load("gather")
    lib.nio_gather_records.restype = ctypes.c_int
    lib.nio_gather_records.argtypes = [
        ctypes.c_void_p, ctypes.c_long, _C_LONG_P, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    return lib


def _jpeg_lib():
    lib = host_build.load("jpeg")
    lib.nio_jpeg_size.restype = ctypes.c_int
    lib.nio_jpeg_size.argtypes = [ctypes.c_char_p, ctypes.c_long, _INT_P,
                                  _INT_P]
    lib.nio_decode_full_u8.restype = ctypes.c_int
    lib.nio_decode_full_u8.argtypes = [ctypes.c_char_p, ctypes.c_long, _U8_P,
                                       ctypes.c_int, ctypes.c_int]
    lib.nio_decode_resize_f32.restype = ctypes.c_int
    lib.nio_decode_resize_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_long, _F32_P, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int]
    lib.nio_batch_decode_files_u8.restype = ctypes.c_int
    lib.nio_batch_decode_files_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8_P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    return lib


def gather_records(base: np.ndarray, indices, out: Optional[np.ndarray] = None,
                   n_threads: int = 1) -> np.ndarray:
    """``base[indices]`` along axis 0 by the library's memcpy loop, with the
    GIL released (``base`` is typically a pack field's ``np.memmap``)."""
    if not base.flags.c_contiguous:
        raise ValueError("gather_records needs a C-contiguous base")
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, got shape {idx.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= base.shape[0]):
        raise IndexError(f"record index out of range [0, {base.shape[0]})")
    if out is None:
        out = np.empty((len(idx),) + base.shape[1:], base.dtype)
    elif (out.shape != (len(idx),) + base.shape[1:] or out.dtype != base.dtype
          or not out.flags.c_contiguous):
        raise ValueError("out does not match the gathered records")
    rec_bytes = int(np.prod(base.shape[1:], dtype=np.int64)
                    * base.dtype.itemsize)
    _gather_lib().nio_gather_records(
        base.ctypes.data_as(ctypes.c_void_p), rec_bytes,
        idx.ctypes.data_as(_C_LONG_P), len(idx),
        out.ctypes.data_as(ctypes.c_void_p), max(int(n_threads), 1))
    return out


def gather_records_plain(base: np.ndarray, indices) -> np.ndarray:
    """``gather_records``' plain version: numpy fancy indexing."""
    return np.asarray(base[np.asarray(indices, np.int64)])


def _hw(hw):
    return (hw, hw) if isinstance(hw, int) else tuple(hw)


def decode_image(data: bytes) -> np.ndarray:
    """One JPEG byte string at full size -> [h, w, 3] uint8 RGB (libjpeg's
    ISLOW IDCT); raises ``ValueError`` if it does not decode."""
    lib = _jpeg_lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.nio_jpeg_size(data, len(data), ctypes.byref(h),
                         ctypes.byref(w)) != 0:
        raise ValueError("not a decodable JPEG")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.nio_decode_full_u8(data, len(data), out.ctypes.data_as(_U8_P),
                              h.value, w.value) != 0:
        raise ValueError("not a decodable JPEG")
    return out


def decode_resize(data: bytes, hw, pad_value: float = 0.0,
                  letterbox: bool = True) -> np.ndarray:
    """One JPEG byte string -> [H, W, 3] f32 in [0, 255]. ``letterbox``:
    aspect-preserving, padded at the bottom and right (detection);
    otherwise a plain stretch (the classification Resize). Raises
    ``ValueError`` if it does not decode."""
    H, W = _hw(hw)
    out = np.empty((H, W, 3), np.float32)
    if _jpeg_lib().nio_decode_resize_f32(
            data, len(data), out.ctypes.data_as(_F32_P), H, W, pad_value,
            int(letterbox)) != 0:
        raise ValueError("not a decodable JPEG")
    return out


def batch_decode_files_u8(paths: Sequence[str], hw, n_threads: int = 0,
                          pad_value: float = 0.0, letterbox: bool = True,
                          return_ok: bool = False):
    """JPEG files -> a collated [N, H, W, 3] uint8 batch (each value
    ``decode_resize``'s rounded), decoded by a thread pool; a file that
    fails leaves a slot of ``pad_value`` and a warning with the count.
    ``return_ok`` also returns the number of files decoded."""
    H, W = _hw(hw)
    n = len(paths)
    out = np.empty((n, H, W, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    ok = _jpeg_lib().nio_batch_decode_files_u8(
        arr, n, out.ctypes.data_as(_U8_P), H, W, n_threads, pad_value,
        int(letterbox))
    if ok < n:
        warnings.warn(f"native JPEG batch decode: {n - ok}/{n} files failed "
                      f"to read/decode; those slots are pad-filled",
                      stacklevel=2)
    return (out, int(ok)) if return_ok else out
