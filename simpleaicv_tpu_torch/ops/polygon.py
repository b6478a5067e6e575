"""Host-side polygon geometry of DBNet's decoder (a copy of
``simpleaicv_tpu/ops/polygon.py``, which needs no cv2): the shoelace area
and the perimeter, the DB unclip distance D = A * ratio / L, the
round-join outward offset of a simple polygon (pyclipper's ``JT_ROUND``
semantics: each edge shifted along its outward normal, convex vertices
joined by arcs sampled at pyclipper's arc tolerance, reflex vertices by
the two offset edges' intersection) and the Sutherland-Hodgman clip to the
image rectangle.
"""

from __future__ import annotations

import numpy as np

__all__ = ["polygon_area", "polygon_perimeter", "offset_polygon",
           "clip_polygon_to_rect", "unclip_distance"]


def polygon_area(pts: np.ndarray) -> float:
    """Shoelace area (positive for CCW), pts [N,2]."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_perimeter(pts: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.roll(pts, -1, axis=0) - pts,
                                       axis=1)))


def unclip_distance(pts: np.ndarray, expand_ratio: float) -> float:
    """DB unclip distance: area * ratio / perimeter (reference
    decode.py:129-130 via shapely Polygon)."""
    per = polygon_perimeter(pts)
    return abs(polygon_area(pts)) * expand_ratio / max(per, 1e-6)


def _ensure_ccw(pts: np.ndarray) -> np.ndarray:
    return pts if polygon_area(pts) >= 0 else pts[::-1]


def offset_polygon(pts: np.ndarray, distance: float,
                   arc_tolerance: float = 0.25) -> np.ndarray:
    """Round-join outward offset of a simple polygon by ``distance`` > 0.

    Returns the offset polygon [M,2] (float32). Arc sampling density follows
    pyclipper's arc tolerance model: step angle = 2*acos(1 - tol/d).
    """
    pts = _ensure_ccw(np.asarray(pts, np.float64))
    n = pts.shape[0]
    if n < 3 or distance <= 0:
        return pts.astype(np.float32)

    # drop duplicate consecutive points
    keep = np.linalg.norm(pts - np.roll(pts, 1, axis=0), axis=1) > 1e-9
    pts = pts[keep]
    n = pts.shape[0]
    if n < 3:
        return pts.astype(np.float32)

    d = float(distance)
    step = 2.0 * np.arccos(max(1.0 - arc_tolerance / max(d, 1e-9), -1.0))
    step = max(step, 0.05)

    prv = np.roll(pts, 1, axis=0)
    nxt = np.roll(pts, -1, axis=0)
    e_in = pts - prv                       # incoming edge dirs
    e_out = nxt - pts                      # outgoing edge dirs
    e_in /= np.linalg.norm(e_in, axis=1, keepdims=True)
    e_out /= np.linalg.norm(e_out, axis=1, keepdims=True)
    # outward normal for CCW polygon: rotate dir by -90deg -> (dy, -dx)
    n_in = np.stack([e_in[:, 1], -e_in[:, 0]], axis=1)
    n_out = np.stack([e_out[:, 1], -e_out[:, 0]], axis=1)

    out = []
    for i in range(n):
        p = pts[i]
        a_start = np.arctan2(n_in[i, 1], n_in[i, 0])
        a_end = np.arctan2(n_out[i, 1], n_out[i, 0])
        cross = e_in[i, 0] * e_out[i, 1] - e_in[i, 1] * e_out[i, 0]
        if cross >= -1e-12:
            # convex (or straight) vertex: arc from n_in to n_out, CCW sweep
            # (outward normals rotate CCW around a convex vertex of a CCW
            # polygon)
            sweep = a_end - a_start
            while sweep < 0:
                sweep += 2 * np.pi
            k = max(int(np.ceil(sweep / step)), 1)
            angles = a_start + sweep * np.arange(k + 1) / k
            for a in angles:
                out.append(p + d * np.array([np.cos(a), np.sin(a)]))
        else:
            # reflex vertex: intersect the two offset edge lines
            p1, d1 = prv[i] + d * n_in[i], e_in[i]
            p2, d2 = p + d * n_out[i], e_out[i]
            den = d1[0] * d2[1] - d1[1] * d2[0]
            if abs(den) < 1e-12:
                out.append(p + d * n_in[i])
            else:
                t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / den
                out.append(p1 + t * d1)
    return np.asarray(out, np.float32)


def clip_polygon_to_rect(pts: np.ndarray, w: float, h: float) -> np.ndarray:
    """Sutherland–Hodgman clip of polygon [N,2] to [0,w]x[0,h]."""
    def clip_edge(poly, inside, intersect):
        out = []
        m = len(poly)
        for i in range(m):
            cur, nxt = poly[i], poly[(i + 1) % m]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def x_cut(a, b, x):
        t = (x - a[0]) / (b[0] - a[0])
        return np.array([x, a[1] + t * (b[1] - a[1])])

    def y_cut(a, b, y):
        t = (y - a[1]) / (b[1] - a[1])
        return np.array([a[0] + t * (b[0] - a[0]), y])

    poly = [np.asarray(p, np.float64) for p in pts]
    for inside, intersect in (
            (lambda p: p[0] >= 0, lambda a, b: x_cut(a, b, 0.0)),
            (lambda p: p[0] <= w, lambda a, b: x_cut(a, b, float(w))),
            (lambda p: p[1] >= 0, lambda a, b: y_cut(a, b, 0.0)),
            (lambda p: p[1] <= h, lambda a, b: y_cut(a, b, float(h)))):
        if not poly:
            return np.zeros((0, 2), np.float32)
        poly = clip_edge(poly, inside, intersect)
    return np.asarray(poly, np.float32)
