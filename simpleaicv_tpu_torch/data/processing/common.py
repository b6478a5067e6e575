"""Shared dataset-preparation primitives (counterpart of
``simpleaicv_tpu/data/processing/common.py``), without OpenCV.

The text conventions are the JAX package's: fullwidth characters fold to
halfwidth, a small punctuation map applies after folding, and the
unrecognisable-text markers ``###``/``#`` become the single sentinel
``IGNORE_CHAR`` (``㍿``). The polygon checks are the JAX package's too:
clip to the image rectangle, reject self-intersections, areas under
``min_area`` and sets whose DB-shrunken polygons overlap.

OpenCV's calls are ``data/raster.py``'s and ``data/image_io.py``'s:
``cv2.resize`` is ``resize_linear_u8`` (OpenCV's fixed point, the same
pixels), ``cv2.pointPolygonTest`` is ``point_polygon_test``,
``cv2.imdecode`` is ``read_image``/``read_grey`` and ``cv2.imencode``
``encode_image``. The images are RGB here where the JAX package's are
BGR; every step acts on each channel alike, and the files written are the
same.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...ops.polygon import (clip_polygon_to_rect, polygon_area,
                            polygon_perimeter)
from ..image_io import read_grey, read_image, write_image
from ..raster import point_polygon_test, resize_linear_u8

IGNORE_CHAR = "㍿"

# fullwidth -> halfwidth punctuation kept in its CJK form upstream
PUNCT_MAP = {"，": ",", "；": ";", "：": ":", "？": "?",
             "（": "(", "）": ")", "！": "!"}

# the two read modes of ``imread_any`` (cv2's flag values)
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1


def half_angle(ch: str) -> str:
    """Fullwidth -> halfwidth."""
    code = ord(ch)
    if code == 12288:  # ideographic space
        code = 32
    elif 65281 <= code <= 65374:
        code -= 65248
    return chr(code)


def normalize_text(text: str) -> str:
    """Strip spaces, fold widths, map punctuation, collapse ###/# to the
    ignore sentinel."""
    text = text.replace(" ", "")
    out = []
    for ch in text:
        ch = half_angle(ch)
        out.append(PUNCT_MAP.get(ch, ch))
    text = "".join(out)
    text = text.replace("###", IGNORE_CHAR).replace("#", IGNORE_CHAR)
    return text


def resize_max_side(image: np.ndarray, polys: Sequence[np.ndarray],
                    max_side: int = 1920
                    ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Resize so max(h, w) == max_side (always rescales), scaling polygons
    with the image."""
    h, w = image.shape[:2]
    factor = max_side / max(h, w)
    nh, nw = math.ceil(h * factor), math.ceil(w * factor)
    image = resize_linear_u8(image, nw, nh)
    return image, [np.asarray(p, np.float64) * factor for p in polys]


def _cross2(a, b) -> float:
    return float(a[0] * b[1] - a[1] * b[0])


def _segments_intersect(p1, p2, p3, p4) -> bool:
    """Proper crossing of segments p1p2 and p3p4."""
    d1 = _cross2(p4 - p3, p1 - p3)
    d2 = _cross2(p4 - p3, p2 - p3)
    d3 = _cross2(p2 - p1, p3 - p1)
    d4 = _cross2(p2 - p1, p4 - p1)
    return ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0))


def is_simple_polygon(pts: np.ndarray) -> bool:
    """No two non-adjacent edges intersect."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if n < 3:
        return False
    for i in range(n):
        a1, a2 = pts[i], pts[(i + 1) % n]
        for j in range(i + 1, n):
            if j == i or (j + 1) % n == i or (i + 1) % n == j:
                continue
            b1, b2 = pts[j], pts[(j + 1) % n]
            if _segments_intersect(a1, a2, b1, b2):
                return False
    return True


def point_in_polygon(pt, pts) -> bool:
    """Inside or on the border of the f32 polygon ``pts``."""
    return point_polygon_test(pts, pt) >= 0


def polygons_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Any edge crossing, or one polygon containing the other."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    na, nb = len(a), len(b)
    for i in range(na):
        for j in range(nb):
            if _segments_intersect(a[i], a[(i + 1) % na],
                                   b[j], b[(j + 1) % nb]):
                return True
    return point_in_polygon(a[0], b) or point_in_polygon(b[0], a)


def shrink_polygon(pts: np.ndarray, shrink_ratio: float = 0.6
                   ) -> Optional[np.ndarray]:
    """DB-style inward offset by d = A * (1 - r^2) / L - 1. None when the
    shrink collapses or flips the polygon."""
    pts = np.asarray(pts, np.float64)
    area = polygon_area(pts)
    if area < 0:
        pts = pts[::-1]
        area = -area
    peri = polygon_perimeter(pts)
    d = area * (1.0 - shrink_ratio ** 2) / max(peri, 1e-6) - 1.0
    if d <= 0:
        return pts.astype(np.float32)
    n = len(pts)
    prv = np.roll(pts, 1, axis=0)
    nxt = np.roll(pts, -1, axis=0)
    e_in = pts - prv
    e_out = nxt - pts
    li = np.linalg.norm(e_in, axis=1, keepdims=True)
    lo = np.linalg.norm(e_out, axis=1, keepdims=True)
    if (li < 1e-9).any() or (lo < 1e-9).any():
        return None
    e_in /= li
    e_out /= lo
    # inward normal for CCW polygon: rotate dir by +90deg -> (-dy, dx)
    n_in = np.stack([-e_in[:, 1], e_in[:, 0]], axis=1)
    n_out = np.stack([-e_out[:, 1], e_out[:, 0]], axis=1)
    out = []
    for i in range(n):
        p1, d1 = prv[i] + d * n_in[i], e_in[i]
        p2, d2 = pts[i] + d * n_out[i], e_out[i]
        den = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(den) < 1e-12:
            out.append(pts[i] + d * n_in[i])
        else:
            t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / den
            out.append(p1 + t * d1)
    out = np.asarray(out, np.float64)
    shrunk_area = polygon_area(out)
    if shrunk_area <= 0 or shrunk_area >= area or not is_simple_polygon(out):
        return None
    return out.astype(np.float32)


def imread_any(path: str, flags: int = IMREAD_COLOR
               ) -> Optional[np.ndarray]:
    """The image at ``path`` as uint8 [H, W, 3] RGB (``IMREAD_COLOR``) or
    [H, W] grey (``IMREAD_GRAYSCALE``); None for an empty file or bytes
    that do not decode, as ``cv2.imdecode`` gives."""
    if os.path.getsize(path) == 0:
        return None
    try:
        return read_grey(path) if flags == IMREAD_GRAYSCALE else \
            read_image(path)
    except ValueError:
        return None


def imwrite_any(path: str, image: np.ndarray) -> None:
    """Writes a uint8 grey or RGB image in the format of the path's
    extension (``.jpg`` without one)."""
    try:
        write_image(path, image)
    except ValueError as e:
        raise IOError(f"cannot encode {path}: {e}") from None


def write_standard_set(out_dir: str, set_name: str,
                       samples: Dict[str, Tuple[np.ndarray, list]],
                       train_ratio: Optional[float] = None,
                       set_type: Optional[str] = None,
                       seed: int = 0) -> Dict[str, int]:
    """Write ``{out_dir}/{train,test}/<name>.jpg`` + per-split
    ``<set_name>_{train,test}.json`` ({name: [{'points','label','ignore'}]}).

    Either ``train_ratio`` (a ``random.Random(seed)`` shuffle, then the
    ratio's cut) or an explicit ``set_type``.
    """
    names = sorted(samples)
    if set_type is not None:
        splits = {set_type: names}
    else:
        rng = random.Random(seed)
        rng.shuffle(names)
        cut = int(len(names) * float(train_ratio))
        splits = {"train": sorted(names[:cut]), "test": sorted(names[cut:])}
    stats = {}
    for split, split_names in splits.items():
        img_dir = os.path.join(out_dir, split)
        os.makedirs(img_dir, exist_ok=True)
        labels = {}
        for name in split_names:
            image, ann = samples[name]
            imwrite_any(os.path.join(img_dir, name), image)
            labels[name] = ann
        with open(os.path.join(out_dir, f"{set_name}_{split}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(labels, f, ensure_ascii=False)
        stats[split] = len(split_names)
    return stats


def validate_and_standardize(image: np.ndarray,
                             boxes: List[Tuple[list, str]],
                             max_side: int = 1920,
                             min_area: float = 9.0,
                             shrink_ratio: float = 0.6
                             ) -> Optional[Tuple[np.ndarray, list]]:
    """One image's validity pipeline. Returns (resized_image, annotations)
    or None when any check rejects the image:

      1. resize to max-side ``max_side``;
      2. every transcript non-empty;
      3. clip each polygon to the image rect — clipping must yield one
         polygon with all coords in range;
      4. no self-intersecting polygon;
      5. every polygon area >= ``min_area``;
      6. DB-shrink at ``shrink_ratio`` must succeed for every polygon and
         the shrunken polygons must be pairwise disjoint.
    """
    if image is None or image.ndim != 3:
        return None
    h, w = image.shape[:2]
    if h < 100 or w < 100:
        return None
    polys = [np.asarray(b, np.float64) for b, _ in boxes]
    texts = [t for _, t in boxes]
    if any(t == "" or t is None for t in texts):
        return None
    image, polys = resize_max_side(image, polys, max_side)
    h, w = image.shape[:2]

    anns = []
    for poly, text in zip(polys, texts):
        clipped = clip_polygon_to_rect(poly, w, h)
        if len(clipped) < 3:
            return None
        if (clipped[:, 0] < -1e-6).any() or (clipped[:, 1] < -1e-6).any() \
                or (clipped[:, 0] > w + 1e-6).any() \
                or (clipped[:, 1] > h + 1e-6).any():
            return None
        anns.append({"points": np.asarray(clipped, np.float64).tolist(),
                     "label": text,
                     "ignore": text == IGNORE_CHAR})

    for ann in anns:
        if not is_simple_polygon(np.asarray(ann["points"])):
            return None
        if abs(polygon_area(np.asarray(ann["points"]))) < min_area:
            return None

    shrunk = []
    for ann in anns:
        s = shrink_polygon(np.asarray(ann["points"]), shrink_ratio)
        if s is None:
            return None
        shrunk.append(s)
    for i in range(len(shrunk)):
        for j in range(i + 1, len(shrunk)):
            if polygons_intersect(shrunk[i], shrunk[j]):
                return None
    return image, anns
