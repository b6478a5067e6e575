"""Recognition text-line crops from standardized detection sets
(counterpart of ``simpleaicv_tpu/data/processing/text_lines.py``), without
OpenCV.

Input: a processed detection set (output of ``processing.text_detection``).
Output: the layout ``data/datasets/text.py``'s recognition readers
consume:

    <out_dir>/{train,test}/<SetName>_<stem>_line<k>.jpg
    <out_dir>/<SetName>_{train,test}.json      # {crop_name: label_string}

Quads are rectified by a perspective warp; longer polygons (curved
LSVT/ART lines, even point count, top run then bottom run) are cut into
the quad chain between opposite point pairs, each quad warped to the
chain's mean height and concatenated horizontally. Near-vertical lines
(h > 1.5 w) are rotated to horizontal.

OpenCV's calls are ``data/raster.py``'s: ``get_perspective_transform``
and ``warp_perspective`` (OpenCV 5's f32 warp, the same pixels on the
tests), ``min_area_rect``/``box_points`` (the fallback of a polygon that
is not a chain of quads; ``min_area_rect`` may break a tie of equal areas
otherwise than OpenCV), ``contour_area`` and
``rotate_90_counterclockwise``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..raster import (box_points, contour_area, get_perspective_transform,
                      min_area_rect, rotate_90_counterclockwise,
                      warp_perspective)
from .common import IGNORE_CHAR, imread_any, imwrite_any, normalize_text


def _order_quad(src: np.ndarray) -> np.ndarray:
    """Order 4 points tl, tr, br, bl: Python's stable sort by x, then each
    pair by y, over the f32 values."""
    src = sorted(np.asarray(src, np.float32).tolist(), key=lambda p: p[0])
    left = sorted(src[:2], key=lambda p: p[1])
    right = sorted(src[2:], key=lambda p: p[1])
    return np.array([left[0], right[0], right[1], left[1]], np.float32)


def warp_quad(image: np.ndarray, quad: np.ndarray
              ) -> Optional[np.ndarray]:
    """Perspective-rectify one quad to an axis-aligned strip."""
    src = _order_quad(quad)
    h1 = np.linalg.norm(src[0] - src[3])
    h2 = np.linalg.norm(src[1] - src[2])
    w1 = np.linalg.norm(src[0] - src[1])
    w2 = np.linalg.norm(src[3] - src[2])
    if min(h1, h2) < 2 or min(w1, w2) < 2:
        return None
    height = int((h1 + h2) / 2.0)
    width = int((w1 + w2) / 2.0)
    dst = np.array([[0, 0], [width - 1, 0], [width - 1, height - 1],
                    [0, height - 1]], np.float32)
    m = get_perspective_transform(src, dst)
    return warp_perspective(image, m, (width, height))


def rectify_curve(image: np.ndarray, poly: np.ndarray
                  ) -> Optional[np.ndarray]:
    """Even-count polygon ordered top-run then bottom-run -> unrolled strip:
    warp each quad between opposite point pairs to the mean height and
    concat horizontally."""
    poly = np.asarray(poly, np.float32)
    n = len(poly)
    if n < 6 or n % 2:
        return None
    k = n // 2
    top = poly[:k]
    bot = poly[k:][::-1]  # bottom run is right-to-left
    heights = np.linalg.norm(top - bot, axis=1)
    height = int(np.clip(heights.mean(), 2, None))
    pieces = []
    for i in range(k - 1):
        quad = np.array([top[i], top[i + 1], bot[i + 1], bot[i]], np.float32)
        width = int(max((np.linalg.norm(top[i + 1] - top[i]) +
                         np.linalg.norm(bot[i + 1] - bot[i])) / 2.0, 2))
        dst = np.array([[0, 0], [width - 1, 0], [width - 1, height - 1],
                        [0, height - 1]], np.float32)
        m = get_perspective_transform(quad, dst)
        pieces.append(warp_perspective(image, m, (width, height)))
    if not pieces:
        return None
    return np.concatenate(pieces, axis=1)


def _extract_line(image: np.ndarray, pts: np.ndarray
                  ) -> Optional[np.ndarray]:
    if len(pts) == 4:
        crop = warp_quad(image, pts)
    else:
        crop = rectify_curve(image, pts)
        if crop is None:  # fall back to the min-area rect of the polygon
            rect = min_area_rect(np.asarray(pts, np.float32))
            crop = warp_quad(image, box_points(rect))
    if crop is None or min(crop.shape[:2]) < 2:
        return None
    h, w = crop.shape[:2]
    if h > 1.5 * w:  # vertical line -> rotate to horizontal
        crop = rotate_90_counterclockwise(crop)
    return crop


def extract_text_lines(detection_root: str, set_name: str, out_dir: str,
                       out_set_name: Optional[str] = None,
                       set_types=("train", "test"), min_area: float = 15.0,
                       max_label_length: int = 80,
                       log=print) -> Dict[str, int]:
    """Walk a processed detection set and write recognition line crops."""
    out_set_name = out_set_name or set_name.replace("text_detection",
                                                    "text_recognition")
    stats = {}
    for set_type in set_types:
        label_path = os.path.join(detection_root, set_name,
                                  f"{set_name}_{set_type}.json")
        img_dir = os.path.join(detection_root, set_name, set_type)
        if not os.path.exists(label_path):
            continue
        with open(label_path, encoding="utf-8") as f:
            labels = json.load(f)
        out_img_dir = os.path.join(out_dir, set_type)
        os.makedirs(out_img_dir, exist_ok=True)
        out_labels = {}
        for image_name in sorted(labels):
            anns = labels[image_name]
            if isinstance(anns, dict):
                anns = anns.get("shapes", [])
            image = imread_any(os.path.join(img_dir, image_name))
            if image is None:
                continue
            stem = os.path.splitext(image_name)[0]
            for k, ann in enumerate(anns):
                text = normalize_text(ann.get("label", ""))
                if ann.get("ignore", False) or not text \
                        or IGNORE_CHAR in text \
                        or len(text) > max_label_length:
                    continue
                pts = np.asarray(ann["points"], np.float32)
                if contour_area(pts) < min_area:
                    continue
                crop = _extract_line(image, pts)
                if crop is None:
                    continue
                crop_name = f"{stem}_line{k}.jpg"
                imwrite_any(os.path.join(out_img_dir, crop_name), crop)
                out_labels[crop_name] = text
        with open(os.path.join(out_dir, f"{out_set_name}_{set_type}.json"),
                  "w", encoding="utf-8") as f:
            json.dump(out_labels, f, ensure_ascii=False)
        stats[set_type] = len(out_labels)
    if log:
        log(f"{out_set_name}: {stats}")
    return stats


def build_char_table(label_json_paths, out_path: Optional[str] = None
                     ) -> list:
    """Deduplicated sorted char table from recognition label jsons. The
    result can be passed to ``CTCTextLabelConverter`` as a custom table;
    for the reference checkpoints' table use
    ``data.char_table.reference_char_table()`` instead."""
    chars = set()
    for path in label_json_paths:
        with open(path, encoding="utf-8") as f:
            labels = json.load(f)
        for text in labels.values():
            chars.update(normalize_text(text if isinstance(text, str)
                                        else text.get("label", "")))
    chars.discard(IGNORE_CHAR)
    table = sorted(chars)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(table, f, ensure_ascii=False)
    return table
