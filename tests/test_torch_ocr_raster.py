"""``simpleaicv_tpu_torch.data.raster`` (OpenCV's raster and contour
geometry rebuilt without cv2) against cv2 on seeded random polygons
(convex and concave), random masks and the fake OCR datasets' samples.

Exact, as integers: the filled, outlined and contour-filled masks, the
elliptic elements (radii 1 to 60), the eroded and dilated masks (radii 1
to 12), the contours' vertices and their order, the convex hulls and the
rendered digits (and the committed glyph table, which
``hershey_digit_table`` builds again with cv2). Within a stated tolerance:
the distance transform (2e-6 of the distance plus 1e-6: OpenCV 5 adds
its steps in f32, the port in f64), the areas and lengths (1e-9 relative), the
rotated rectangles (1e-4 absolute on int contours; on float points the
area within 1e-5 relative, the rectangle itself where no other rectangle
has the same area within f32 rounding), the box corners (1e-5) and the
Douglas-Peucker polygons (at least 99% of them equal; the others made of
the curve's own points, within the tolerance of the curve and at most two
vertices from OpenCV's count). The port modules of the OCR slice import
none of cv2, jax, flax, optax or ``simpleaicv_tpu``."""

import ast
import os

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data import text_detection as jax_det
from simpleaicv_tpu.data import text_recognition as jax_rec
from simpleaicv_tpu_torch.data import raster
from simpleaicv_tpu_torch.data import text_recognition as port_rec
from simpleaicv_tpu_torch.data.transforms import resize_bilinear

from _torch_port import one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "simpleaicv_tpu_torch")
SLICE_MODULES = [
    "data/raster.py", "data/text_detection.py", "data/text_recognition.py",
    "data/char_table.py", "ops/polygon.py", "models/text_detection.py",
    "models/text_recognition.py", "losses/text_detection.py",
    "losses/text_recognition.py", "evaluation/text_eval.py",
    "tasks/text_detection.py", "tasks/text_recognition.py",
    "tools/train_text_detection.py", "tools/test_text_detection.py",
    "tools/train_text_recognition.py", "tools/test_text_recognition.py"]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _polygons(rng, n_cases, side):
    """Seeded polygons inside a side x side image: star-shaped ones from
    sorted angles (convex and concave) and arbitrary vertex lists
    (self-intersecting too)."""
    polys = []
    for t in range(n_cases):
        n = rng.randint(3, 12)
        if t % 2:
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rad = rng.uniform(side / 12, side / 2 - 1, n)
            p = np.stack([side / 2 + rad * np.cos(ang),
                          side / 2 + rad * np.sin(ang)], 1)
        else:
            p = rng.randint(0, side, (n, 2))
        polys.append(np.clip(p, 0, side - 1).astype(np.int32))
    return polys


def _masks(rng, n_cases):
    """Random masks: noise at three densities and rectangles with
    holes."""
    out = []
    for t in range(n_cases):
        if t % 4 == 3:
            m = np.zeros((60, 70), np.uint8)
            for _ in range(rng.randint(1, 6)):
                x, y = rng.randint(0, 60, 2)
                m[y:y + rng.randint(1, 20), x:x + rng.randint(1, 20)] ^= 1
        else:
            m = (rng.rand(40, 50) < (0.3, 0.5, 0.7)[t % 4 % 3]).astype(
                np.uint8)
        out.append(m)
    return out


def test_slice_modules_import_no_cv2_jax_or_the_jax_package():
    banned = ("cv2", "jax", "flax", "optax", "simpleaicv_tpu")
    for rel in SLICE_MODULES:
        with open(os.path.join(PORT, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (rel, name)


def test_fill_poly_and_polylines_equal_opencv():
    rng = np.random.RandomState(0)
    for side in (32, 97):
        for p in _polygons(rng, 300, side):
            want = cv2.fillPoly(np.zeros((side, side), np.uint8), [p], 1)
            got = raster.fill_poly(np.zeros((side, side), np.uint8), p, 1)
            assert np.array_equal(got, want), p.tolist()
            want = cv2.polylines(np.zeros((side, side), np.uint8), [p],
                                 True, 1)
            got = raster.polylines(np.zeros((side, side), np.uint8), p, 1)
            assert np.array_equal(got, want), p.tolist()
            # the decoder's drawContours(..., -1) of one contour
            want = cv2.drawContours(np.zeros((side, side), np.uint8),
                                    [p.reshape(-1, 1, 2)], -1, 1, -1)
            got = raster.fill_poly(np.zeros((side, side), np.uint8),
                                   p.reshape(-1, 1, 2), 1)
            assert np.array_equal(got, want), p.tolist()
    # a float canvas, as the map generator's ignore mask
    p = np.array([[3, 4], [20, 6], [11, 25]], np.int32)
    want = cv2.fillPoly(np.ones((30, 30), np.float32), [p], 0.0)
    assert np.array_equal(raster.fill_poly(np.ones((30, 30), np.float32), p,
                                           0.0), want)


def test_elements_erode_and_dilate_equal_opencv():
    rng = np.random.RandomState(1)
    for r in range(1, 61):
        want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE,
                                         (2 * r + 1, 2 * r + 1))
        assert np.array_equal(raster.ellipse_element(2 * r + 1), want), r
    polys = _polygons(rng, 12, 96)
    for r in range(1, 13):
        el = raster.ellipse_element(2 * r + 1)
        noise = (rng.rand(70, 90) < 0.7).astype(np.uint8)
        noise[:5] = 1  # set along the border: OpenCV's border never erodes
        shape = cv2.fillPoly(np.zeros((96, 96), np.uint8), [polys[r - 1]], 1)
        for m in (noise, shape):
            assert np.array_equal(raster.erode(m, el), cv2.erode(m, el)), r
            assert np.array_equal(raster.dilate(m, el), cv2.dilate(m, el)), r
    empty = np.zeros((10, 10), np.uint8)
    el = raster.ellipse_element(7)
    assert not raster.erode(empty, el).any()
    assert not raster.dilate(empty, el).any()


def test_distance_transform_within_f32_rounding_of_opencv():
    rng = np.random.RandomState(2)
    cases = [(rng.rand(120, 90) < (0.9, 0.99, 0.999, 0.9999)[t % 4]).astype(
        np.uint8) for t in range(12)]
    # the map generator's input: 1 outside a polygon's outline
    p = _polygons(rng, 1, 80)[0]
    cases.append(1 - cv2.polylines(np.zeros((80, 80), np.uint8), [p], True,
                                   1))
    for m in cases:
        m[0, 0] = 0
        want = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        got = raster.distance_transform_l2_3(m)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert (np.abs(got - want) <= 2e-6 * want + 1e-6).all()
    # no zero pixel: OpenCV 5 leaves every pixel at FLT_MAX
    ones = np.ones((6, 7), np.uint8)
    assert np.array_equal(raster.distance_transform_l2_3(ones),
                          cv2.distanceTransform(ones, cv2.DIST_L2, 3))


def _contour_sets():
    rng = np.random.RandomState(3)
    masks = _masks(rng, 160)
    ds = jax_det.FakeTextDetectionDataset(image_hw=160)
    masks += [(ds[i]["probability_mask"] > 0.3).astype(np.uint8)
              for i in range(8)]
    # a detection map with noise: thresholded probabilities
    noisy = ds[0]["probability_mask"] * 0.8 + 0.3 * rng.rand(160, 160)
    masks.append((noisy > 0.5).astype(np.uint8))
    return masks


def test_find_contours_equal_opencv():
    for m in _contour_sets():
        want, _ = cv2.findContours(m, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
        got = raster.find_contours(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and np.array_equal(g, w)
    assert raster.find_contours(np.zeros((5, 5), np.uint8)) == []


def test_contour_measures_hulls_and_rectangles_against_opencv():
    contours = [c for m in _contour_sets()[-12:] for c in
                cv2.findContours(m, cv2.RETR_LIST,
                                 cv2.CHAIN_APPROX_SIMPLE)[0]]
    assert len(contours) > 50
    for c in contours:
        assert raster.contour_area(c) == pytest.approx(
            cv2.contourArea(c), rel=1e-9, abs=1e-9)
        assert raster.arc_length(c) == pytest.approx(
            cv2.arcLength(c, True), rel=1e-9, abs=1e-9)
        assert np.array_equal(raster.convex_hull(c), cv2.convexHull(c))
        if len(c) < 3:
            continue
        want, got = cv2.minAreaRect(c), raster.min_area_rect(c)
        assert np.allclose(np.r_[got[0], got[1], got[2]],
                           np.r_[want[0], want[1], want[2]], rtol=0,
                           atol=1e-4), (got, want)
        assert np.abs(raster.box_points(want)
                      - cv2.boxPoints(want)).max() <= 1e-5
    rng = np.random.RandomState(4)
    differ = 0
    for t in range(200):
        p = (rng.rand(rng.randint(3, 30), 1, 2) * 100).astype(np.float32)
        assert np.array_equal(raster.convex_hull(p), cv2.convexHull(p))
        want, got = cv2.minAreaRect(p), raster.min_area_rect(p)
        assert got[1][0] * got[1][1] == pytest.approx(
            want[1][0] * want[1][1], rel=1e-5)
        differ += not np.allclose(np.r_[got[0], got[1], got[2]],
                                  np.r_[want[0], want[1], want[2]],
                                  rtol=0, atol=1e-3)
    # a hull whose smallest rectangles tie (three sides of a triangle with
    # the same area) may resolve the tie the other way
    assert differ <= 6, differ


def test_approx_poly_dp_against_opencv():
    rng = np.random.RandomState(5)
    contours = [c for m in _contour_sets()[-10:] for c in
                cv2.findContours(m, cv2.RETR_LIST,
                                 cv2.CHAIN_APPROX_SIMPLE)[0] if len(c) > 2]
    total = differ = 0
    for c in contours:
        for mult in (1, 3, 10, 30):
            eps = 1e-3 * cv2.arcLength(c, True) * mult
            want = cv2.approxPolyDP(c, eps, True)
            got = raster.approx_poly_dp(c, eps)
            total += 1
            if np.array_equal(got, want):
                continue
            differ += 1
            pts = {tuple(v) for v in c.reshape(-1, 2).tolist()}
            assert all(tuple(v) in pts for v in got.reshape(-1, 2).tolist())
            assert abs(len(got) - len(want)) <= 2
    assert differ <= 0.01 * total, (differ, total)


def hershey_digit_table(places=8, org=(8, 40), shape=(64, 240)):
    """The glyph table of ``data/hershey_digits.npz``, built with cv2: each
    digit's ink (255 minus the grey level OpenCV 5 draws on white) at each
    place of a string, isolated as the pixels it changes after a prefix of
    some digit that left them white."""
    def render(s):
        img = np.full(shape, 255, np.uint8)
        if s:
            cv2.putText(img, s, org, cv2.FONT_HERSHEY_SIMPLEX, 1.2, 0, 2)
        return img

    ink = np.zeros((10, places) + shape, np.uint8)
    for d in range(10):
        ink[d, 0] = 255 - render(str(d))
        for i in range(1, places):
            for e in range(10):
                prefix = render(str(e) * i)
                ink[d, i] = np.maximum(ink[d, i], np.where(
                    prefix == 255, 255 - render(str(e) * i + str(d)), 0))
    ys, xs = np.nonzero(ink.any(axis=(0, 1)))
    crop = ink[:, :, ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return crop, int(ys.min()) - org[1], int(xs.min()) - org[0]


def test_digit_table_and_text_equal_opencv():
    ink, row0, col0 = hershey_digit_table()
    with np.load(os.path.join(PORT, "data", "hershey_digits.npz")) as z:
        assert np.array_equal(z["ink"], ink)
        assert (int(z["row0"]), int(z["col0"])) == (row0, col0)
    jax_ds, port_ds = (jax_rec.FakeTextRecognitionDataset(300),
                       port_rec.FakeTextRecognitionDataset(300))
    for i in range(300):
        a, b = jax_ds[i], port_ds[i]
        assert a["label"] == b["label"]
        assert np.array_equal(a["image"], b["image"]), i
    # another origin and a grey image of one channel
    img = np.full((40, 200), 255, np.uint8)
    want = cv2.putText(img.copy(), "9081726354"[:8], (11, 30),
                       cv2.FONT_HERSHEY_SIMPLEX, 1.2, 0, 2)
    assert np.array_equal(raster.put_digits(img, "90817263", (11, 30)),
                          want)
    with pytest.raises(ValueError):
        raster.put_digits(img, "12a", (0, 30))


def test_resize_against_opencv():
    """The recognition collater's resize (48 high to 32, f32) within 1e-3
    of ``cv2.resize`` (OpenCV sums its f32 taps in another order)."""
    ds = port_rec.FakeTextRecognitionDataset(8)
    for i in range(8):
        img = ds[i]["image"]
        h, w = img.shape[:2]
        nw = int(round(w * 32 / h))
        got = resize_bilinear(img, 32, nw)
        want = cv2.resize(img, (nw, 32))
        assert np.abs(got - want).max() <= 1e-3
