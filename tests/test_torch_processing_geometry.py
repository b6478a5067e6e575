"""OpenCV's pieces of the port's dataset preparation, held against cv2 on
this machine (``simpleaicv_tpu_torch/data/raster.py``,
``data/image_io.py``, ``data/interactive_segmentation.py``):

* ``resize_nearest`` (the mask resize of six transforms) gathers at
  ``cv2.resize(INTER_NEAREST)``'s places over a seeded sweep of sizes,
  and the port's ``SamResize`` gives the JAX one's mask at three sizes
  where ``F.interpolate``'s f32 nearest map did not;
* ``get_perspective_transform`` against ``cv2.getPerspectiveTransform``
  (to 1e-9 of the largest entry; the LU solve is OpenCV's, so equal here)
  on quads whose points are not on a line;
* ``warp_perspective`` against ``cv2.warpPerspective`` on seeded quads,
  grey and colour: equal on every value;
* ``resize_linear_u8`` against ``cv2.resize`` (``INTER_LINEAR``) at three
  sizes scaled to max side 1920, up and down: equal on every value;
* ``rotate_90_counterclockwise``, ``point_polygon_test``'s sign (inside,
  outside, on an edge, on a vertex) and ``bounding_rect`` (an empty mask
  included) against their cv2 calls;
* JPEG bytes of ``encode_image`` against ``cv2.imencode`` for colour and
  grey, and the pixels of its PNGs against ``cv2.imdecode``.
"""

import math

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data.interactive_segmentation import \
    SamResize as JaxSamResize
from simpleaicv_tpu_torch.data import image_io, raster
from simpleaicv_tpu_torch.data.interactive_segmentation import (
    SamResize, resize_nearest)

from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _quad_case(rng, c):
    """An image of c channels, 4 source points around and beyond it, and
    the warp's destination size."""
    h, w = rng.randint(40, 200, 2)
    shape = (h, w, c) if c == 3 else (h, w)
    image = rng.randint(0, 256, shape).astype(np.uint8)
    src = (rng.rand(4, 2) * [w, h] * 1.4 - 0.2 * np.array([w, h])).astype(
        np.float32)
    ow, oh = (int(v) for v in rng.randint(2, 160, 2))
    dst = np.array([[0, 0], [ow - 1, 0], [ow - 1, oh - 1], [0, oh - 1]],
                   np.float32)
    return image, src, dst, (ow, oh)


# -- the repaired nearest resize --------------------------------------------

def test_resize_nearest_gathers_at_cv2_places():
    rng = np.random.RandomState(0)
    for _ in range(400):
        h, w = (int(v) for v in rng.randint(2, 3000, 2))
        factor = 1024 / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        rows = np.repeat(np.arange(h, dtype=np.float32)[:, None], 2, 1)
        cols = np.repeat(np.arange(w, dtype=np.float32)[None], 2, 0)
        for mask, size in ((rows, (2, nh)), (cols, (nw, 2))):
            want = cv2.resize(mask, size, interpolation=cv2.INTER_NEAREST)
            got = resize_nearest(mask, size[1], size[0])
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=str((h, w)))


@pytest.mark.parametrize("hw", [(902, 2276), (660, 1429), (2710, 1535)])
def test_sam_resize_mask_equals_jax(hw):
    rng = np.random.RandomState(hw[0])
    image = (rng.rand(*hw, 3) * 255).astype(np.float32)
    mask = rng.randint(0, 2, hw).astype(np.float32)
    want = JaxSamResize(1024)({"image": image, "mask": mask.copy()})
    got = SamResize(1024)({"image": image, "mask": mask.copy()})
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["scale"] == want["scale"]
    # the image: F.interpolate's bilinear taps against cv2's f32 resize,
    # whose weights differ in their last digits (0.0302 of 255 at most, at
    # 2710x1535)
    np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                               atol=0.05)


# -- the perspective warp ---------------------------------------------------

def test_get_perspective_transform_matches_cv2():
    rng = np.random.RandomState(1)
    for _ in range(200):
        _, src, dst, _ = _quad_case(rng, 1)
        want = cv2.getPerspectiveTransform(src, dst)
        got = raster.get_perspective_transform(src, dst)
        assert got.dtype == np.float64 and got.shape == (3, 3)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_perspective_matches_cv2(channels):
    rng = np.random.RandomState(2 + channels)
    for _ in range(30):
        image, src, dst, size = _quad_case(rng, channels)
        m = cv2.getPerspectiveTransform(src, dst)
        want = cv2.warpPerspective(image, m, size)
        got = raster.warp_perspective(image, m, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# -- resize, rotation, point test, box -------------------------------------

@pytest.mark.parametrize("hw", [(480, 640), (1200, 1600), (2000, 1500)])
def test_resize_linear_u8_matches_cv2(hw):
    image = np.random.RandomState(hw[1]).randint(0, 256, hw + (3,)).astype(
        np.uint8)
    factor = 1920 / max(hw)
    nh, nw = math.ceil(hw[0] * factor), math.ceil(hw[1] * factor)
    np.testing.assert_array_equal(raster.resize_linear_u8(image, nw, nh),
                                  cv2.resize(image, (nw, nh)))
    grey = image[..., 1]
    np.testing.assert_array_equal(raster.resize_linear_u8(grey, 97, 61),
                                  cv2.resize(grey, (97, 61)))


def test_rotate_90_counterclockwise_matches_cv2():
    image = np.random.RandomState(3).randint(0, 256, (5, 9, 3)).astype(
        np.uint8)
    for a in (image, image[..., 0]):
        np.testing.assert_array_equal(
            raster.rotate_90_counterclockwise(a),
            cv2.rotate(a, cv2.ROTATE_90_COUNTERCLOCKWISE))


def test_point_polygon_test_sign_matches_cv2():
    square = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    cases = {(5, 5): 1, (15, 5): -1, (10, 4.5): 0, (5, 0): 0, (10, 10): 0,
             (0, 0): 0, (-0.5, 3): -1}
    for pt, sign in cases.items():
        want = cv2.pointPolygonTest(square.reshape(-1, 1, 2), pt, False)
        assert want == sign
        assert raster.point_polygon_test(square, pt) == sign
    rng = np.random.RandomState(4)
    for _ in range(500):
        poly = (rng.rand(rng.randint(3, 9), 2) * 10).round(
            rng.randint(0, 2)).astype(np.float32)
        pt = poly[rng.randint(len(poly))] if rng.rand() < 0.2 else \
            (rng.rand(2) * 10).round(rng.randint(0, 2))
        want = cv2.pointPolygonTest(poly.reshape(-1, 1, 2),
                                    (float(pt[0]), float(pt[1])), False)
        assert raster.point_polygon_test(poly, pt) == want


def test_bounding_rect_matches_cv2():
    rng = np.random.RandomState(5)
    for _ in range(20):
        mask = (rng.rand(30, 40) > 0.97).astype(np.uint8)
        assert raster.bounding_rect(mask) == cv2.boundingRect(mask)
    empty = np.zeros((7, 5), np.uint8)
    assert raster.bounding_rect(empty) == cv2.boundingRect(empty) == \
        (0, 0, 0, 0)


# -- encoding ---------------------------------------------------------------

def test_jpeg_bytes_equal_cv2_and_png_pixels_decode_alike():
    rng = np.random.RandomState(6)
    rgb = cv2.GaussianBlur(rng.randint(0, 256, (61, 83, 3)).astype(
        np.uint8), (5, 5), 1.5)
    grey = rgb[..., 0].copy()
    for image, bgr in ((rgb, rgb[..., ::-1]), (grey, grey)):
        ok, want = cv2.imencode(".jpg", bgr)
        assert ok and image_io.encode_image(".jpg", image) == want.tobytes()
        body = np.frombuffer(image_io.encode_image(".png", image), np.uint8)
        flag = cv2.IMREAD_UNCHANGED
        np.testing.assert_array_equal(cv2.imdecode(body, flag), bgr)
