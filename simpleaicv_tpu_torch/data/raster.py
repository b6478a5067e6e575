"""OpenCV's raster and contour geometry of the OCR and matting pipelines,
without cv2 (the port does not depend on OpenCV). Every function here
stands for one OpenCV 5 call of ``simpleaicv_tpu/data/text_detection.py``,
``data/text_recognition.py``, ``data/matting.py`` or
``evaluation/text_eval.py`` and follows OpenCV's own algorithm, in its
own fixed point or float precision, so that the integer outputs are
OpenCV's exactly (``tests/test_torch_ocr_raster.py`` holds each against
cv2):

* ``fill_poly`` (``cv2.fillPoly``; OpenCV fills one contour of
  ``drawContours(..., -1)`` the same way): the polygon's outline by
  8-connected Bresenham lines and its scanlines by the even-odd rule over
  edges in 16.16 fixed point;
* ``polylines`` (``cv2.polylines``, closed, thickness 1, ``LINE_8``);
* ``ellipse_element`` (``getStructuringElement(MORPH_ELLIPSE)``), and
  ``erode`` and ``dilate`` of 0/1 masks by it with OpenCV's border
  (outside pixels never erode and never dilate), row by row over the
  element's runs;
* ``distance_transform_l2_3`` (``distanceTransform(DIST_L2, 3)``): the
  3x3 chamfer of weights 0.955 and 1.3693, its two passes as min-plus
  scans along each row (in f64, where OpenCV 5 adds in f32: the float
  output within about 1e-6 of the distance);
* ``find_contours`` (``findContours(RETR_LIST, CHAIN_APPROX_SIMPLE)``):
  Suzuki-Abe border following as OpenCV codes it, the contours in
  OpenCV's order (the last found first);
* ``contour_area``, ``arc_length``, ``approx_poly_dp`` (Douglas-Peucker
  from OpenCV's starting point), ``convex_hull`` (Sklansky),
  ``min_area_rect`` (rotating calipers in f32, OpenCV 5's angle) and
  ``box_points``, each of a closed curve as the OCR path calls them;
* the pieces of the offline dataset preparation
  (``simpleaicv_tpu/data/processing``): ``get_perspective_transform``
  (OpenCV's 8x8 system and its LU solve, in f64 as OpenCV orders it),
  ``warp_perspective`` (``INTER_LINEAR``, zero border, uint8: OpenCV 5
  maps and blends in f32), ``resize_linear_u8`` (``INTER_LINEAR`` on
  uint8 in OpenCV's 11-bit fixed point), ``nearest_indices`` and
  ``resize_nearest_index`` (``INTER_NEAREST``'s source rows and columns,
  in f64), ``rotate_90_counterclockwise``, ``point_polygon_test``'s sign
  and ``bounding_rect``;
* ``put_digits`` (``putText`` of digits in ``FONT_HERSHEY_SIMPLEX`` at
  scale 1.2, thickness 2, ``LINE_8``): a glyph table,
  ``hershey_digits.npz``, one bitmap for each digit and place in the
  string (OpenCV advances each glyph in 16.16 fixed point, so a glyph's
  pixels depend on its place), stamped at the text's origin. The table was
  made with cv2 (``tests/test_torch_ocr_raster.py::hershey_digit_table``
  builds it again and compares).

Lines and polygons whose vertices lie outside the image are clipped as
OpenCV clips them (``clipLine``) before they are drawn and filled, as
COCO and SA-1B polygons on an image's border need.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np


__all__ = ["fill_poly", "polylines", "ellipse_element", "erode", "dilate",
           "distance_transform_l2_3", "find_contours", "contour_area",
           "arc_length", "approx_poly_dp", "convex_hull", "min_area_rect",
           "box_points", "put_digits", "nearest_indices",
           "resize_nearest_index", "bounding_rect", "resize_linear_u8",
           "get_perspective_transform", "warp_perspective",
           "rotate_90_counterclockwise", "point_polygon_test"]

_SHIFT = 16
_ONE = 1 << _SHIFT


def _line_pixels(p0, p1):
    """(ys, xs) of OpenCV's 8-connected ``LineIterator`` from p0 to p1
    (left to right): the major axis steps every pixel, the minor one
    where the error term ``dx - 2 dy`` (then ``-2 dy``, plus ``2 dx``
    after a minor step) is negative before the step."""
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # minor steps taken before pixel k: the count of j < k with
    # major - 2 minor (j + 1) + 2 major m_j < 0, in closed form
    m = (2 * minor * k + major - 1) // (2 * major) if major else k * 0
    if vert:
        return y0 + sy * k, x0 + m
    return y0 + sy * m, x0 + k


def _put_pixels(img, ys, xs, value):
    h, w = img.shape[:2]
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[keep], xs[keep]] = value


def _outside(h, w, *pts):
    return any(not (0 <= x < w and 0 <= y < h) for x, y in pts)


def _clip_line(h, w, p0, p1):
    """OpenCV's ``clipLine`` of the segment p0-p1 to the image, in its
    order of steps (a y side first, then an x side; the second point's
    step reads the first's clipped x): (inside, clipped p0, clipped p1).
    The points are moved even when the segment misses the image."""
    (x1, y1), (x2, y2) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line(img, p0, p1, value):
    """OpenCV's ``Line`` (8-connected): a segment with an end outside the
    image is clipped first, and one that misses it draws nothing."""
    h, w = img.shape[:2]
    if _outside(h, w, p0, p1):
        inside, p0, p1 = _clip_line(h, w, p0, p1)
        if not inside:
            return
    ys, xs = _line_pixels(p0, p1)
    _put_pixels(img, ys, xs, value)


def _outline(img, pts, value):
    for i in range(len(pts)):
        _line(img, pts[i - 1], pts[i], value)


def polylines(img, pts, value):
    """``cv2.polylines(img, [pts], True, value)`` (thickness 1, ``LINE_8``,
    shift 0) in place on a 2-D array; ``pts`` [N, 2] int."""
    _outline(img, np.asarray(pts, np.int64).reshape(-1, 2), value)
    return img


def _poly_edges(h, w, pts):
    """The edges of OpenCV 5's ``fillPoly`` (``LINE_8``, shift 0): for
    each non-horizontal edge its rows [y0, y1), its 16.16 x at row y0 and
    its 16.16 step a row (the slope truncated toward 0). An edge with an
    end outside the image runs along its clipped segment (``clipLine``),
    at the clipped x where that segment is flat, over the rows of the
    unclipped edge."""
    edges = []
    for i in range(len(pts)):
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        if y0 == y1:
            continue
        top = min(y0, y1)
        c0, c1 = (x0 << _SHIFT, y0), (x1 << _SHIFT, y1)
        if _outside(h, w, (x0, y0), (x1, y1)):
            _, t0, t1 = _clip_line(h, w, (x0, y0), (x1, y1))
            if t0[1] == t1[1]:
                edges.append((top, max(y0, y1), t0[0] << _SHIFT, 0))
                continue
            c0, c1 = (t0[0] << _SHIFT, t0[1]), (t1[0] << _SHIFT, t1[1])
        num, den = c1[0] - c0[0], c1[1] - c0[1]
        dx = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
        c = c0 if y0 < y1 else c1
        edges.append((top, max(y0, y1), c[0] + (top - c[1]) * dx, dx))
    return edges


def fill_poly(img, pts, value):
    """``cv2.fillPoly(img, [pts], value)`` (``LINE_8``, shift 0) in place on
    a 2-D array; ``pts`` [N, 2] int. Each edge's outline pixels
    (``_line``), then the even-odd scanlines of OpenCV's
    ``FillEdgeCollection``: each row's sorted edge crossings pair into
    spans from ceil(left) to floor(right), clipped to the image. The
    edges are OpenCV's (``_poly_edges``), clipped where a vertex lies
    outside the image. OpenCV 5 rounds its spans otherwise in places,
    but only on pixels its outline covers too: the union is the same
    (held against cv2 on random polygons, inside the image and across
    its border)."""
    pts = [(int(x), int(y)) for x, y in
           np.asarray(pts, np.int64).reshape(-1, 2)]
    if not pts:
        return img
    _outline(img, pts, value)
    h, w = img.shape[:2]
    edges = _poly_edges(h, w, pts)
    if len(edges) < 2:
        return img
    top, bottom, x_top, slope = (np.array(v, np.int64) for v in zip(*edges))
    counts = bottom - top
    edge = np.repeat(np.arange(len(top)), counts)
    start = np.repeat(np.cumsum(counts) - counts, counts)
    step = np.arange(counts.sum()) - start
    rows = top[edge] + step
    xs = x_top[edge] + step * slope[edge]
    inside = (rows >= 0) & (rows < h)
    rows, xs = rows[inside], xs[inside]
    if rows.size == 0:
        return img
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # pair the crossings of each row: (0, 1), (2, 3), ...
    first = np.r_[True, rows[1:] != rows[:-1]]
    rank = np.arange(rows.size) - np.maximum.accumulate(
        np.where(first, np.arange(rows.size), 0))
    li = np.nonzero(rank % 2 == 0)[0]
    li = li[li + 1 < rows.size]
    li = li[rows[li + 1] == rows[li]]
    y = rows[li]
    x1 = (xs[li] + _ONE - 1) >> _SHIFT
    x2 = xs[li + 1] >> _SHIFT
    ok = (x1 < w) & (x2 >= 0)
    y, x1, x2 = y[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok], w - 1)
    if y.size == 0:
        return img
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (y, x1), 1)
    np.add.at(diff, (y, x2 + 1), -1)
    covered = np.cumsum(diff[:, :w], axis=1) > 0
    img[covered] = value
    return img


def ellipse_element(size=5):
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))``."""
    r = c = size // 2
    el = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) / (r * r))))
        el[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return el


def _morph(img, element, erode_: bool):
    mask = np.asarray(img) != 0
    h, w = mask.shape
    r = element.shape[0] // 2
    out = np.zeros((h, w), np.uint8)
    rows, cols = np.nonzero(mask.any(1))[0], np.nonzero(mask.any(0))[0]
    if rows.size == 0:
        return out
    y0, y1, x0, x1 = rows[0], rows[-1], cols[0], cols[-1]
    if not erode_:
        y0, y1 = max(y0 - r, 0), min(y1 + r, h - 1)
        x0, x1 = max(x0 - r, 0), min(x1 + r, w - 1)
    ho, wo = y1 - y0 + 1, x1 - x0 + 1
    padded = np.pad(mask, r, constant_values=erode_)
    sub = padded[y0:y1 + 2 * r + 1, x0:x1 + 2 * r + 1]
    cs = np.zeros((sub.shape[0], sub.shape[1] + 1), np.int32)
    np.cumsum(sub, axis=1, out=cs[:, 1:])
    acc = np.full((ho, wo), erode_, bool)
    for i in range(element.shape[0]):
        on = np.nonzero(element[i])[0]
        if on.size == 0:
            continue
        j1, j2 = on[0], on[-1] + 1
        run = cs[i:i + ho, j2:j2 + wo] - cs[i:i + ho, j1:j1 + wo]
        if erode_:
            acc &= run == j2 - j1
        else:
            acc |= run > 0
    out[y0:y1 + 1, x0:x1 + 1] = acc
    return out


def erode(img, element):
    """``cv2.erode(img, element)`` of a 0/1 mask (uint8 0/1 out): a pixel
    stays where the whole element over it is set; outside the image counts
    as set. ``element`` is a symmetric element whose rows are runs
    (``ellipse_element``)."""
    return _morph(img, element, True)


def dilate(img, element):
    """``cv2.dilate(img, element)`` of a 0/1 mask (uint8 0/1 out); outside
    the image counts as unset."""
    return _morph(img, element, False)


# OpenCV's 3x3 L2 weights, as f32 numbers
_HV, _DIAG = float(np.float32(0.955)), float(np.float32(1.3693))


def distance_transform_l2_3(src):
    """``cv2.distanceTransform(src, cv2.DIST_L2, 3)``: [h, w] f32, each
    nonzero pixel's 3x3-chamfer distance (steps of 0.955 and 1.3693) to
    the nearest zero pixel; outside the image is no zero, and a pixel that
    no zero reaches is FLT_MAX, as OpenCV 5 leaves it. A forward pass from
    the row above and the left, a backward pass from the row below and the
    right; along a row each is a min-plus scan, t[j] = min(a[j], t[j -/+ 1]
    + 0.955), taken in f64 as j * 0.955 + the running minimum of
    a[k] - k * 0.955. OpenCV adds its steps one by one in f32, so the two
    part by f32 rounding: about 1e-6 of the distance."""
    zero = np.asarray(src) == 0
    h, w = zero.shape
    j = np.arange(w, dtype=np.float64) * _HV
    t = np.full((h + 2, w + 2), np.inf)
    for i in range(h):
        up = t[i]
        a = np.minimum(np.minimum(up[:-2], up[2:]) + _DIAG, up[1:-1] + _HV)
        a[zero[i]] = 0.0
        t[i + 1, 1:-1] = j + np.minimum.accumulate(a - j)
    for i in range(h, 0, -1):
        down = t[i + 1]
        b = np.minimum(np.minimum(down[:-2], down[2:]) + _DIAG,
                       down[1:-1] + _HV)
        b = np.minimum(b, t[i, 1:-1])
        t[i, 1:-1] = (j + np.minimum.accumulate(b[::-1] - j))[::-1]
    t = t[1:-1, 1:-1]
    t[np.isinf(t)] = np.finfo(np.float32).max
    return t.astype(np.float32)


# OpenCV's chain-code directions: 0 right, then counter-clockwise
_CODE = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
         (1, 1))
_LABEL, _RIGHT_EDGE = 2, 2 | -128


def _follow(img, step, i0, x, y, hole):
    """OpenCV's ``icvFetchContour`` with ``CHAIN_APPROX_SIMPLE`` from the
    start pixel ``i0`` (flat index, at (x, y) of the unpadded image) of
    the flat label list ``img``: marks the border (-126 where its right
    neighbour was examined as 0, else 2 over 1) and returns the corners."""
    deltas = [1, 1 - step, -step, -step - 1, -1, step - 1, step, step + 1]
    deltas = deltas + deltas
    s = s_end = 0 if hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:
        img[i0] = _RIGHT_EDGE
        return [(x, y)]
    points = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        i4 = i3
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            img[i3] = _RIGHT_EDGE
        elif img[i3] == 1:
            img[i3] = _LABEL
        if s != prev_s:
            points.append((x, y))
            prev_s = s
        x += _CODE[s][0]
        y += _CODE[s][1]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return points


def find_contours(binary):
    """``cv2.findContours(binary, cv2.RETR_LIST,
    cv2.CHAIN_APPROX_SIMPLE)[0]``: a list of [N, 1, 2] int32 contours of
    the nonzero pixels, outer borders and holes, in OpenCV's order.

    OpenCV pads the image with one zero pixel, scans it row by row and
    starts a border where a 0 meets an unvisited 1 (outer) or a visited
    or unvisited positive pixel meets a 0 on its right (hole), as its
    labels stand at that moment. Only such meetings can start one, so the
    scan here visits the 0/1 transitions of the image (found with numpy)
    in raster order and reads the labels there. The border following
    itself walks pixel by pixel in Python."""
    mask = np.asarray(binary) != 0
    h, w = mask.shape
    padded = np.zeros((h + 2, w + 2), np.int8)
    padded[1:-1, 1:-1] = mask
    step = w + 2
    trans_y, trans_x = np.nonzero(padded[1:-1, 1:-1] != padded[1:-1, :-2])
    img = padded.ravel().tolist()
    found = []
    for y, x in zip((trans_y + 1).tolist(), (trans_x + 1).tolist()):
        at = y * step + x
        p, prev = img[at], img[at - 1]
        if prev == 0 and p == 1:
            found.append(_follow(img, step, at, x - 1, y - 1, False))
        elif p == 0 and prev >= 1:
            found.append(_follow(img, step, at - 1, x - 2, y - 1, True))
    return [np.asarray(c, np.int32).reshape(-1, 1, 2)
            for c in reversed(found)]


def contour_area(pts) -> float:
    """``cv2.contourArea``: the absolute shoelace sum over f32 vertices,
    each product in f64, added in order."""
    p = np.asarray(pts).reshape(-1, 2).astype(np.float32).astype(np.float64)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return abs(float(np.cumsum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0])[-1])
               * 0.5)


def arc_length(pts) -> float:
    """``cv2.arcLength(pts, True)``: each side's length in f32, added in
    f64 in order."""
    p = np.asarray(pts).reshape(-1, 2).astype(np.float32)
    if len(p) < 2:
        return 0.0
    d = p - np.roll(p, 1, axis=0)
    side = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    return float(np.cumsum(side.astype(np.float64))[-1])


def approx_poly_dp(curve, epsilon: float):
    """``cv2.approxPolyDP(curve, epsilon, True)`` of a closed int curve:
    OpenCV's Douglas-Peucker (its start from two passes that each take the
    point farthest from the last, its stack order and its last pass that
    drops points on near-straight runs). Returns [M, 1, 2] of the curve's
    dtype."""
    src = np.asarray(curve).reshape(-1, 2)
    pts = [tuple(v) for v in src.tolist()]
    count = len(pts)
    if count == 0:
        return np.zeros((0, 1, 2), src.dtype)
    eps = float(epsilon) ** 2
    stack, out = [], []
    pos = right_start = 0
    for _ in range(3):
        pos = (pos + right_start) % count
        start = pts[pos]
        pos = (pos + 1) % count
        max_dist = 0.0
        for k in range(1, count):
            pt = pts[pos]
            pos = (pos + 1) % count
            dx, dy = pt[0] - start[0], pt[1] - start[1]
            dist = float(dx * dx + dy * dy)
            if dist > max_dist:
                max_dist, right_start = dist, k
    if max_dist <= eps:
        out.append(start)
    else:
        s_end = (right_start + pos) % count
        stack += [(s_end, pos), (pos, s_end)]
    while stack:
        s_start, s_end = stack.pop()
        end, start = pts[s_end], pts[s_start]
        pos = (s_start + 1) % count
        le_eps = True
        if pos != s_end:
            dx, dy = float(end[0] - start[0]), float(end[1] - start[1])
            max_dist, split = 0.0, s_start
            while pos != s_end:
                pt = pts[pos]
                pos = (pos + 1) % count
                dist = abs((pt[1] - start[1]) * dx - (pt[0] - start[0]) * dy)
                if dist > max_dist:
                    max_dist, split = dist, (pos + count - 1) % count
            le_eps = max_dist * max_dist <= eps * (dx * dx + dy * dy)
        if le_eps:
            out.append(start)
        else:
            stack += [(split, s_end), (s_start, split)]
    # last pass: drop points on [almost] straight runs
    dst = list(out)
    count = new_count = len(dst)
    start, pt = dst[-1], dst[0]
    pos = 1 % count
    wpos = i = 0
    while i < count and new_count > 2:
        end = dst[pos]
        pos = (pos + 1) % count
        dx, dy = end[0] - start[0], end[1] - start[1]
        dist = abs((pt[0] - start[0]) * dy - (pt[1] - start[1]) * dx)
        inner = ((pt[0] - start[0]) * (end[0] - pt[0])
                 + (pt[1] - start[1]) * (end[1] - pt[1]))
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0
                and dy != 0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start = end
            wpos = (wpos + 1) % count
            pt = dst[pos]
            pos = (pos + 1) % count
            i += 2
            continue
        dst[wpos] = start = pt
        wpos = (wpos + 1) % count
        pt = end
        i += 1
    return np.asarray(dst[:new_count], src.dtype).reshape(-1, 1, 2)


def _sklansky(p, start, end, nsign, sign2):
    """OpenCV's ``Sklansky_`` over the x-sorted points ``p`` (a list of
    (x, y)): the hull chain from ``start`` to ``end``; returns the stack
    of indices."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or p[start] == p[end]:
        return [start]
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = p[pcur][1], p[pnext][1]
        by = nexty - cury
        if (by > 0) - (by < 0) != nsign:
            ax = p[pcur][0] - p[pprev][0]
            bx = p[pnext][0] - p[pcur][0]
            ay = cury - p[pprev][1]
            conv = ay * bx - ax * by
            if (conv > 0) - (conv < 0) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points):
    """``cv2.convexHull(points, clockwise=False, returnPoints=True)``:
    [K, 1, 2] of the points' dtype, OpenCV's start and order."""
    src = np.asarray(points).reshape(-1, 2)
    is_float = src.dtype.kind == "f"
    vals = src.astype(np.float64 if is_float else np.int64).tolist()
    total = len(vals)
    if total == 0:
        return np.zeros((0, 1, 2), src.dtype)
    order = sorted(range(total), key=lambda i: (vals[i][0], vals[i][1], i))
    p = [tuple(vals[i]) for i in order]
    miny = maxy = 0
    for i in range(1, total):
        y = p[i][1]
        if p[miny][1] > y:
            miny = i
        if p[maxy][1] < y:
            maxy = i
    hull = []
    if p[0] == p[-1]:
        hull.append(0)
    else:
        tl = _sklansky(p, 0, maxy, -1, 1)
        tr = _sklansky(p, total - 1, maxy, -1, -1)
        tl, tr = tr, tl  # counter-clockwise output
        hull += [order[i] for i in tl[:-1]]
        hull += [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        bl = _sklansky(p, 0, miny, 1, -1)
        br = _sklansky(p, total - 1, miny, 1, 1)
        if stop >= 0:
            check = bl[1] if len(bl) > 2 else (
                br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
            if check == stop or (check >= 0 and p[check] == p[stop]):
                bl, br = bl[:2], br[:2]
        hull += [order[i] for i in bl[:-1]]
        hull += [order[br[i]] for i in range(len(br) - 1, 0, -1)]
        hull = _cyclic_shift(hull)
    return src[hull].reshape(-1, 1, 2)


def _cyclic_shift(hull):
    """OpenCV's last step: rotate the hull so that its indices ascend or
    descend where a cyclic shift can make them."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            out, j = [], i0
            for i in range(nout):
                cur = hull[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    break
                j = nj
            else:
                return out
    return hull


_F = np.float32


def _calipers(pts):
    """OpenCV's ``rotatingCalipers(CALIPERS_MINAREARECT)`` in f32 over the
    hull ``pts`` (a list of f32 pairs): (corner, side 1, side 2)."""
    n = len(pts)
    vect, inv = [], []
    left = bottom = right = top = 0
    left_x = right_x = pts[0][0]
    top_y = bottom_y = pts[0][1]
    pt0 = pts[0]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = pts[(i + 1) % n]
        dx = float(pt[0]) - float(pt0[0])
        dy = float(pt[1]) - float(pt0[1])
        vect.append((_F(dx), _F(dy)))
        inv.append(_F(1.0 / math.sqrt(dx * dx + dy * dy)))
        pt0 = pt
    orientation = _F(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        conv = ax * by - ay * bx
        if conv != 0:
            orientation = _F(1) if conv > 0 else _F(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("degenerate hull")
    base_a, base_b = orientation, _F(0)
    seq = [bottom, right, top, left]
    minarea = _F(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        dp = (base_a * vect[seq[0]][0] + base_b * vect[seq[0]][1],
              -base_b * vect[seq[1]][0] + base_a * vect[seq[1]][1],
              -base_a * vect[seq[2]][0] - base_b * vect[seq[2]][1],
              base_b * vect[seq[3]][0] - base_a * vect[seq[3]][1])
        maxcos = dp[0] * inv[seq[0]]
        main = 0
        for i in range(1, 4):
            c = dp[i] * inv[seq[i]]
            if c > maxcos:
                main, maxcos = i, c
        pi = seq[main]
        lead_x, lead_y = vect[pi][0] * inv[pi], vect[pi][1] * inv[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = pts[seq[1]][0] - pts[seq[3]][0]
        dy = pts[seq[1]][1] - pts[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx = pts[seq[2]][0] - pts[seq[0]][0]
        dy = pts[seq[2]][1] - pts[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * pts[i_left][0] + pts[i_left][1] * b1
    c2 = a2 * pts[i_bottom][0] + pts[i_bottom][1] * b2
    idet = _F(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points):
    """``cv2.minAreaRect(points)``: ((cx, cy), (w, h), angle) as OpenCV 5
    gives it, rotating calipers in f32 over ``convex_hull``'s points."""
    hull = convex_hull(points).reshape(-1, 2).astype(np.float32)
    n = len(hull)
    pts = [(_F(x), _F(y)) for x, y in hull.tolist()]
    if n > 2:
        o, s1, s2 = _calipers(pts)
        cx = o[0] + (s1[0] + s2[0]) * _F(0.5)
        cy = o[1] + (s1[1] + s2[1]) * _F(0.5)
        w = _F(math.sqrt(float(s1[0]) ** 2 + float(s1[1]) ** 2))
        h = _F(math.sqrt(float(s2[0]) ** 2 + float(s2[1]) ** 2))
        angle = _F(math.atan2(float(s1[1]), float(s1[0])))
    elif n == 2:
        cx = (pts[0][0] + pts[1][0]) * _F(0.5)
        cy = (pts[0][1] + pts[1][1]) * _F(0.5)
        dx = float(pts[1][0]) - float(pts[0][0])
        dy = float(pts[1][1]) - float(pts[0][1])
        w, h = _F(math.sqrt(dx * dx + dy * dy)), _F(0)
        angle = _F(math.atan2(dy, dx))
    else:
        cx, cy = pts[0] if n == 1 else (_F(0), _F(0))
        w = h = angle = _F(0)
    angle = _F(float(angle) * 180 / math.pi)
    # OpenCV 5 gives the same rectangle with its angle in [-90, 0): each
    # step of 90 degrees swaps the sides
    while angle >= 0:
        angle, w, h = angle - _F(90), h, w
    while angle < -90:
        angle, w, h = angle + _F(90), h, w
    return (float(cx), float(cy)), (float(w), float(h)), float(angle)


def box_points(rect):
    """``cv2.boxPoints(rect)``: the rectangle's 4 corners [4, 2] f32 in
    OpenCV's order, computed in f32."""
    (cx, cy), (w, h), angle = rect
    cx, cy, w, h = _F(cx), _F(cy), _F(w), _F(h)
    a_rad = float(_F(angle)) * math.pi / 180.0
    b = _F(math.cos(a_rad)) * _F(0.5)
    a = _F(math.sin(a_rad)) * _F(0.5)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (_F(2) * cx - p0[0], _F(2) * cy - p0[1])
    p3 = (_F(2) * cx - p1[0], _F(2) * cy - p1[1])
    return np.array([p0, p1, p2, p3], np.float32)


@lru_cache(maxsize=1)
def _digit_glyphs():
    path = os.path.join(os.path.dirname(__file__), "hershey_digits.npz")
    with np.load(path) as z:
        return z["ink"], int(z["row0"]), int(z["col0"])


def put_digits(img, text: str, org):
    """``cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 1.2,
    (0, 0, 0), 2)`` for a string of digits, in place on a white uint8
    [h, w] or [h, w, c] image. OpenCV 5 draws the Hershey fonts
    anti-aliased (whatever the line type), so the table holds each
    glyph's ink (255 minus its grey level) for each place in the string;
    the glyphs are shifted by ``org`` (whole pixels, so the 16.16 advances
    keep their fractions) and clipped to the image. Glyphs do not
    overlap, so on white the darker of the image and each glyph is
    OpenCV's pixel."""
    ink, row0, col0 = _digit_glyphs()
    if len(text) > ink.shape[1] or not text.isdigit():
        raise ValueError(f"put_digits draws up to {ink.shape[1]} digits, "
                         f"not {text!r}")
    shade = np.zeros(ink.shape[2:], np.uint8)
    for i, c in enumerate(text):
        shade = np.maximum(shade, ink[int(c), i])
    h, w = img.shape[:2]
    y0, x0 = org[1] + row0, org[0] + col0
    ys, xs = np.nonzero(shade)
    level = 255 - shade[ys, xs]
    ys, xs = ys + y0, xs + x0
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    ys, xs, level = ys[keep], xs[keep], level[keep]
    if img.ndim == 3:
        level = level[:, None]
    img[ys, xs] = np.minimum(img[ys, xs], level)
    return img


# ------------------------------------------------ dataset preparation


def nearest_indices(src: int, dst: int) -> np.ndarray:
    """The source index of each of ``dst`` places under cv2
    ``INTER_NEAREST``: ``min(floor(x * (1 / (dst / src))), src - 1)``, in
    f64 as OpenCV computes it (``F.interpolate``'s nearest mode takes the
    scale in f32 and parts from it by a row or column at many sizes)."""
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                      src - 1)


def resize_nearest_index(image: np.ndarray, out_h: int, out_w: int
                         ) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h), interpolation=INTER_NEAREST)``
    of an [h, w] or [h, w, c] array, in its own dtype."""
    iy = nearest_indices(image.shape[0], out_h)
    ix = nearest_indices(image.shape[1], out_w)
    return np.asarray(image)[iy[:, None], ix[None, :]]


def bounding_rect(mask: np.ndarray):
    """(x, y, w, h) of the nonzero pixels of a 2-D mask, (0, 0, 0, 0) when
    it has none (cv2.boundingRect's convention)."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return 0, 0, 0, 0
    x0, y0 = int(xs.min()), int(ys.min())
    return x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1


def _linear_taps(src: int, dst: int, clamp_weight: bool):
    """OpenCV's ``INTER_LINEAR`` taps of one axis: the two source indices
    and their 11-bit weights, ``saturate_cast<short>(w * 2048)`` of the f32
    weights at ``(d + 0.5) * scale - 0.5``. The columns clamp their weight
    to (2048, 0) at the borders; the rows keep theirs and clamp the rows."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weight:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0
        s[lo], s[hi] = 0, src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def resize_linear_u8(image: np.ndarray, out_w: int, out_h: int
                     ) -> np.ndarray:
    """``cv2.resize(image, (out_w, out_h))`` (``INTER_LINEAR``) of a uint8
    [h, w] or [h, w, c] image, equal to OpenCV's bit for bit: the columns
    blended in 11-bit fixed point into int32, then the rows as OpenCV's
    vector path does, each row sum shifted right by 4, multiplied by its
    weight keeping the high 16 bits, the two added and rounded off by 2
    bits. (An f32 bilinear resize rounded to uint8 is a level off on about
    a tenth of the values.)"""
    img = np.asarray(image)
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, out_w, True)
    y0, y1, b0, b1 = _linear_taps(h, out_h, False)
    im = img.astype(np.int32).reshape(h, w, -1)
    rows = im[:, x0] * a0[None, :, None] + im[:, x1] * a1[None, :, None]
    out = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((out_h, out_w) + img.shape[2:])


def _lu_solve(a, b):
    """OpenCV's ``LUImpl`` (``cv::solve(..., DECOMP_LU)``) on Python floats:
    partial pivoting on the largest magnitude, elimination by
    ``-1 / pivot``, back substitution, each operation in f64 in OpenCV's
    order. None when a pivot is under ``100 * DBL_EPSILON``."""
    a = [list(row) for row in a]
    b = list(b)
    m = len(a)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < 2.220446049250313e-16 * 100:
            return None
        if k != i:
            a[i][i:], a[k][i:] = a[k][i:], a[i][i:]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return b


def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)``: the [3, 3] f64 homography
    taking 4 f32 points onto 4 others, from OpenCV's 8x8 system (its
    products ``-src * dst`` in f32) solved as ``DECOMP_LU`` solves it.
    Where that solve meets a pivot under its threshold (source or
    destination points on a line), OpenCV 5 returns one of the many null
    vectors of the system, found by SVD; this returns zeros with the last
    entry 1, which warps to a black image."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy = src[i]
        dx, dy = dst[i]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6], a[i][7] = float(-sx * dx), float(-sy * dx)
        a[i + 4][6], a[i + 4][7] = float(-sx * dy), float(-sy * dy)
        b[i], b[i + 4] = float(dx), float(dy)
    x = _lu_solve(a, b) or [0.0] * 8
    return np.array(x + [1.0], np.float64).reshape(3, 3)


def _invert_3x3(m) -> np.ndarray:
    """``cv2.invert(m, DECOMP_LU)`` of a 3x3 f64 matrix: OpenCV's cofactor
    formula in its order; zeros when the determinant is 0."""
    s = [[float(v) for v in row] for row in np.asarray(m, np.float64)]
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if d == 0:
        return np.zeros((3, 3))
    d = 1.0 / d
    return np.array([
        (s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d,
        (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
        (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d,
        (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
        (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d,
        (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
        (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d,
        (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
        (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]).reshape(3, 3)


def _fma32(a, b, c):
    """f32 ``fma(a, b, c)``: the product exact in f64, one rounding to f32
    (a second rounding of the f64 sum differs from a fused one only where
    that sum lies on an f32 tie, beyond 2^-29 of the values)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# OpenCV 5's warp kernels map 16 columns at a time (its AVX2 build) and
# the last columns of a row one at a time, each in its own f32 order
_WARP_BLOCK = 16


def warp_perspective(image: np.ndarray, m, dsize) -> np.ndarray:
    """``cv2.warpPerspective(image, m, dsize)`` (``INTER_LINEAR``, a zero
    constant border) of a uint8 [h, w] or [h, w, c] image, as OpenCV 5
    computes it in f32: ``m`` inverted as ``cv2.invert`` does and cut to
    f32; each destination pixel's source place as ``fma(x, M0, y * M1 +
    M2)`` in the vector blocks of a row and ``fma(x, M0, y * M1) + M2`` in
    its last ``w % 16`` columns, over the same for the denominator; the
    four neighbours (0 outside the image) blended by ``fma`` along x, then
    y; rounded half to even and saturated. Equal to OpenCV's values on
    this repository's tests (8.4 million values of 200 seeded quads)."""
    out_w, out_h = int(dsize[0]), int(dsize[1])
    img = np.asarray(image)
    h, w = img.shape[:2]
    im = img.reshape(h, w, -1)
    mi = _invert_3x3(m).astype(np.float32).ravel()
    ys, xs = np.meshgrid(np.arange(out_h, dtype=np.float32),
                         np.arange(out_w, dtype=np.float32), indexing="ij")
    tail = (out_w // _WARP_BLOCK) * _WARP_BLOCK

    def mapped(i):
        yb = ys * mi[i + 1]
        v = _fma32(xs, mi[i], yb + mi[i + 2])
        v[:, tail:] = (_fma32(xs[:, tail:], mi[i], yb[:, tail:])
                       + mi[i + 2])
        return v

    with np.errstate(all="ignore"):
        den = mapped(6)
        sx, sy = mapped(0) / den, mapped(3) / den
        bad = ~(np.isfinite(sx) & np.isfinite(sy))
        sx[bad] = sy[bad] = -4
        fx, fy = np.floor(sx), np.floor(sy)
        alpha, beta = (sx - fx)[..., None], (sy - fy)[..., None]
    ix = np.clip(fx, -4, w + 4).astype(np.int64)
    iy = np.clip(fy, -4, h + 4).astype(np.int64)

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = im[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v.astype(np.float32),
                        np.float32(0))

    p00, p01 = pixel(iy, ix), pixel(iy, ix + 1)
    p10, p11 = pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    top = _fma32(alpha, p01 - p00, p00)
    bottom = _fma32(alpha, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(beta, bottom - top, top)), 0, 255)
    return out.astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])


def rotate_90_counterclockwise(image: np.ndarray) -> np.ndarray:
    """``cv2.rotate(image, cv2.ROTATE_90_COUNTERCLOCKWISE)``."""
    return np.ascontiguousarray(np.rot90(np.asarray(image)))


def point_polygon_test(pts, pt) -> int:
    """The sign of ``cv2.pointPolygonTest(f32 contour, pt, False)``: 1
    inside, -1 outside, 0 on an edge or a vertex. OpenCV's crossing count
    over the f32 vertices, each edge's cross product from f32 differences
    in f64."""
    c = np.asarray(pts, np.float32).reshape(-1, 2)
    if len(c) == 0:
        return -1
    px, py = np.float32(pt[0]), np.float32(pt[1])
    counter = 0
    vx, vy = c[-1]
    for x, y in c:
        v0x, v0y, vx, vy = vx, vy, x, y
        if ((v0y <= py and vy <= py) or (v0y > py and vy > py)
                or (v0x < px and vx < px)):
            if py == vy and (px == vx or (py == v0y and (
                    (v0x <= px <= vx) or (vx <= px <= v0x)))):
                return 0
            continue
        dist = (float(py - v0y) * float(vx - v0x)
                - float(px - v0x) * float(vy - v0y))
        if dist == 0:
            return 0
        if vy < v0y:
            dist = -dist
        counter += dist > 0
    return -1 if counter % 2 == 0 else 1
