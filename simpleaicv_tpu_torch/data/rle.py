"""COCO compressed RLE codec in pure numpy, the port's own copy of
``simpleaicv_tpu/data/rle.py`` (parity: pycocotools
``mask.encode``/``mask.decode``, used by the reference's SA-1B label
preprocessing — reference simpleAICV/interactive_segmentation/
interactive_segmentation_dataset_preprocessing/
001.convert_png_jpg_label_to_json_label.py:93-95 — and by real SA-1B
annotation files; pycocotools is not installed in this environment).

Format: column-major (Fortran order) run lengths, first run counts zeros;
counts beyond the second are difference-coded against ``counts[i-2]`` and
each signed value is emitted 5 bits at a time, low bits first, into
printable chars offset by 48 with bit 0x20 as the continuation flag
(pycocotools common/maskApi.c ``rleToString``/``rleFrString``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rle_encode", "rle_decode", "mask_to_rle_counts",
           "rle_counts_to_mask"]


def mask_to_rle_counts(mask: np.ndarray) -> list:
    """Binary [H,W] mask -> uncompressed column-major counts list."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # Fortran order
    if flat.size == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0] == 1:  # counts must start with a zero-run
        counts = [0] + counts
    return counts


def rle_counts_to_mask(counts, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T


def _compress(counts) -> str:
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            # sign-aware termination: if the 5th bit (sign) is set, stop
            # once the remaining value is all-ones (negative done), else
            # once it is zero
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
    return "".join(out)


def _decompress(s: str) -> list:
    counts = []
    i = 0
    n = len(s)
    while i < n:
        x, k = 0, 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode(mask: np.ndarray) -> dict:
    """Binary [H,W] mask -> {'size': [H,W], 'counts': str} (COCO compressed)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _compress(mask_to_rle_counts(mask))}


def rle_decode(rle: dict) -> np.ndarray:
    """{'size': [H,W], 'counts': str-or-list} -> binary [H,W] uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _decompress(counts)
    return rle_counts_to_mask(counts, h, w)
