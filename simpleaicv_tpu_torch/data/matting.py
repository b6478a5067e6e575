"""Human-matting data pipeline (counterpart of
``simpleaicv_tpu/data/matting.py``), without OpenCV: a square-stretch resize
(the image and alpha bilinear, the trimap by nearest neighbour so that its
{0, 128, 255} coding survives), a horizontal flip, /255 and a collater onto
zero-padded NHWC canvases, and the synthetic ``FakeHumanMattingDataset``.

The JAX package's OpenCV calls become numpy and torch:

* ``cv2.resize`` (``INTER_LINEAR`` on f32): ``F.interpolate(bilinear,
  align_corners=False, antialias=False)``, the same source points
  (``data.transforms.resize_bilinear``); ``INTER_NEAREST``: a gather at
  OpenCV's source index, computed in f64 (``data.interactive_segmentation.
  resize_nearest``);
* ``cv2.ellipse`` (filled): OpenCV's own polygon, outline and convex fill
  in its 16.16 fixed point, rebuilt in Python; OpenCV clips an outline
  edge that leaves the canvas before it draws it and this rebuild does
  not, so a few boundary pixels may differ there (counted and bounded in
  ``tests/test_torch_matting.py``);
* ``cv2.GaussianBlur((7, 7), 2.0)``: the separable normalised Gaussian over
  ``BORDER_REFLECT_101`` (numpy's ``reflect``) padding;
* ``cv2.erode``/``cv2.dilate`` of the 0/1 masks with the 5x5
  ``MORPH_ELLIPSE`` element: ``data.raster``'s, exact.

The flip draws from ``np_rng`` (a ``numpy.random.RandomState``), or from the
global ``numpy.random`` state as the JAX package does when none is given.
"""

from __future__ import annotations

import numpy as np

from .interactive_segmentation import resize_nearest
from .raster import dilate, ellipse_element, erode
from .transforms import _np, resize_bilinear

__all__ = ["MattingResize", "MattingRandomHorizontalFlip", "MattingNormalize",
           "HumanMattingCollater", "FakeHumanMattingDataset",
           "fill_ellipse", "gaussian_blur", "ellipse_element", "erode",
           "dilate"]


class MattingResize:
    """Stretches image, alpha and trimap to resize x resize."""

    def __init__(self, resize=832):
        self.resize = resize

    def __call__(self, sample):
        s = self.resize
        sample["image"] = resize_bilinear(sample["image"], s, s)
        sample["alpha"] = resize_bilinear(sample["alpha"][..., None], s,
                                          s)[..., 0]
        sample["trimap"] = resize_nearest(sample["trimap"], s, s)
        sample["size"] = np.array([s, s], np.float32)
        return sample


class MattingRandomHorizontalFlip:

    def __init__(self, prob=0.5, np_rng=None):
        self.prob = prob
        self.np_rng = np_rng

    def __call__(self, sample):
        if _np(self.np_rng).uniform(0, 1) < self.prob:
            for key in ("image", "alpha", "trimap"):
                sample[key] = sample[key][:, ::-1].copy()
        return sample


class MattingNormalize:
    """image -> [0, 1]; alpha is on [0, 1] already; the trimap stays raw."""

    def __call__(self, sample):
        sample["image"] = sample["image"] / 255.0
        return sample


class HumanMattingCollater:
    """-> image [B, S, S, 3], alpha [B, S, S] and trimap [B, S, S] (values
    {0, 128, 255}), f32 on zero-padded canvases."""

    def __init__(self, resize=832):
        self.resize = resize

    def __call__(self, samples):
        b, s = len(samples), self.resize
        images = np.zeros((b, s, s, 3), np.float32)
        alphas = np.zeros((b, s, s), np.float32)
        trimaps = np.zeros((b, s, s), np.float32)
        for i, smp in enumerate(samples):
            h, w = smp["image"].shape[:2]
            images[i, :h, :w] = smp["image"]
            alphas[i, :h, :w] = smp["alpha"]
            trimaps[i, :h, :w] = smp["trimap"]
        return {"image": images, "alpha": alphas, "trimap": trimaps}


_SHIFT = 16          # OpenCV's drawing works in 16.16 fixed point
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _tdiv(a, b):
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _sin(deg):
    """OpenCV's table: the f32 sine of a whole degree."""
    return float(np.float32(np.sin(np.deg2rad(deg))))


def _ellipse_vertices(center, axes, angle):
    """``ellipse2Poly``'s polygon in 16.16 fixed point: a vertex every
    ``delta`` degrees (90, 30, 18 or 5 by the longer axis), the angle
    rounded to whole degrees, consecutive repeats dropped."""
    cx, cy = center[0] * _ONE, center[1] * _ONE
    a, b = axes[0] * _ONE, axes[1] * _ONE
    angle = int(np.rint(angle)) % 360
    d = max(axes[0], axes[1])
    delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    cos_t, sin_t = _sin(450 - angle), _sin(angle)
    pts = []
    for i in range(0, 360 + delta, delta):
        t = min(i, 360)
        x, y = a * _sin(450 - t), b * _sin(t)
        p = (int(np.rint(cx + x * cos_t - y * sin_t)),
             int(np.rint(cy + x * sin_t + y * cos_t)))
        if not pts or p != pts[-1]:
            pts.append(p)
    return pts if len(pts) > 1 else [(cx, cy)] * 2


def _put(img, x, y, value):
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = value


def _line(img, p1, p2, value):
    """OpenCV's 8-connected fixed-point line (``Line2``), unclipped: each
    pixel is bound-checked instead."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if (dx if x_major else dy) < 0:
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    if x_major:
        step = _tdiv(dy << _SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        step = _tdiv(dx << _SHIFT, abs(dy) | 1)
        count = (y2 - y1) >> _SHIFT
    x1, y1 = x1 + _HALF, y1 + _HALF
    _put(img, (x2 + _HALF) >> _SHIFT, (y2 + _HALF) >> _SHIFT, value)
    if x_major:
        x1 >>= _SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> _SHIFT, value)
            x1, y1 = x1 + 1, y1 + step
    else:
        y1 >>= _SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> _SHIFT, y1, value)
            x1, y1 = x1 + step, y1 + 1


def fill_ellipse(img, center, axes, angle, value):
    """``cv2.ellipse(img, center, axes, angle, 0, 360, value, -1)`` on a 2-D
    array, in place, as OpenCV draws it: the polygon of
    ``_ellipse_vertices``, its outline by ``_line`` and its rows by
    ``FillConvexPoly``'s two edge walkers, each row's ends rounded to
    pixels."""
    v = _ellipse_vertices(center, axes, angle)
    n = len(v)
    for i in range(n):
        _line(img, v[i - 1], v[i], value)
    h, w = img.shape
    ys = [p[1] for p in v]
    y = (min(ys) + _HALF) >> _SHIFT
    ymax = min((max(ys) + _HALF) >> _SHIFT, h - 1)
    imin = ys.index(min(ys))
    # per walker: [vertex index, direction, x, x step, its last row]
    edges = [[imin, 1, -_ONE, 0, y], [imin, n - 1, -_ONE, 0, y]]
    left = n
    while True:
        for e in edges:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while True:
                left -= 1
                if left < 0:
                    break
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[:] = [idx, e[1], xs,
                            _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + e[1]) % n
        if left < 0:
            break
        if y >= 0:
            xa, xb = sorted((edges[0][2], edges[1][2]))
            x1, x2 = (xa + _HALF) >> _SHIFT, (xb + _HALF) >> _SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
        edges[0][2] += edges[0][3]
        edges[1][2] += edges[1][3]
        y += 1
        if y > ymax:
            break
    return img


def gaussian_blur(img, ksize=7, sigma=2.0):
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of a 2-D f32 array:
    the normalised Gaussian along each axis over reflect-101 padding."""
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    pad = ksize // 2
    out = np.pad(img.astype(np.float32), pad, mode="reflect")
    hh, ww = img.shape
    out = sum(k[i] * out[i:i + hh] for i in range(ksize))
    return sum(k[i] * out[:, i:i + ww] for i in range(ksize)).astype(
        np.float32)


class FakeHumanMattingDataset:
    """Synthetic portrait-like samples: a soft-edged ellipse as the alpha
    over a random background, the trimap from eroding and dilating it, as
    the real dataset derives it; each drawn from a generator seeded by
    (seed, index)."""

    def __init__(self, num_samples=32, image_hw=64, transform=None, seed=0):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        hw = self.image_hw
        alpha = np.zeros((hw, hw), np.float32)
        cy, cx = rng.randint(hw // 4, 3 * hw // 4, 2)
        ay, ax = rng.randint(hw // 6, hw // 3, 2)
        fill_ellipse(alpha, (cx, cy), (ax, ay), rng.uniform(0, 180), 1.0)
        alpha = gaussian_blur(alpha, 7, 2.0)
        fg = rng.uniform(0, 255, 3).astype(np.float32)
        bg = rng.uniform(0, 255, 3).astype(np.float32)
        image = alpha[..., None] * fg + (1 - alpha[..., None]) * bg
        image += rng.randn(hw, hw, 3).astype(np.float32) * 4

        k = ellipse_element(5)
        eroded = erode((alpha > 0.95).astype(np.uint8), k)
        dilated = dilate((alpha > 0.05).astype(np.uint8), k)
        trimap = np.zeros((hw, hw), np.float32)
        trimap[dilated > 0] = 128.0
        trimap[eroded > 0] = 255.0

        sample = {"image": np.clip(image, 0, 255).astype(np.float32),
                  "alpha": alpha, "trimap": trimap,
                  "scale": np.float32(1.0),
                  "size": np.array([hw, hw], np.float32)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
