"""The port's shared image decode (``simpleaicv_tpu_torch/data/
image_io.py``, which ``demo/codec.py`` re-exports) against OpenCV's
``imread`` on files written on this machine:

* ``decode_grey`` against ``IMREAD_GRAYSCALE`` and ``decode_image``
  against ``IMREAD_COLOR`` then ``COLOR_BGR2RGB``, equal on every value:
  grey, bilevel, 4-bit grey, LA, 16-bit grey, RGB, RGBA and palette PNGs
  (with and without ``tRNS``); colour JPEGs at three qualities and three
  chroma samplings, a grey JPEG and CMYK JPEGs; BMP, TIFF, GIF and
  lossless WebP files;
* a colour PNG's grey is libpng's (9797 R + 19234 G + 3737 B) >> 15, on
  colours where ``cvtColor``'s rounding gives another value;
* a missing file and bytes that do not decode raise ``ValueError``
  naming the file, where ``cv2.imread`` returns None;
* the module imports no cv2, jax, flax, optax or the JAX package.
"""

import ast
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from simpleaicv_tpu_torch.data import image_io
from simpleaicv_tpu_torch.demo import codec

PORT = Path(__file__).resolve().parent.parent / "simpleaicv_tpu_torch"


def _smooth(h, w, c, seed):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, c) * 255).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5).reshape(h, w, c)


def _files(root):
    """(name, path) of every kind, from smooth noise of 61 x 83."""
    rgb = _smooth(61, 83, 3, 0)
    a = _smooth(61, 83, 1, 1)[..., 0]
    wide = (a.astype(np.uint16) * 257
            + np.random.RandomState(2).randint(0, 256, a.shape)).astype(
        np.uint16)
    kinds = {
        "grey.png": (Image.fromarray(a), {}),
        "bilevel.png": (Image.fromarray(a > 128), {}),
        "grey4.png": (Image.fromarray(a // 17 * 17), {"bits": 4}),
        "la.png": (Image.fromarray(np.dstack([a, 255 - a])), {}),
        "grey16.png": (Image.fromarray(wide), {}),
        "rgb.png": (Image.fromarray(rgb), {}),
        "rgba.png": (Image.fromarray(np.dstack([rgb, a])), {}),
        "palette.png": (Image.fromarray(rgb).quantize(64), {}),
        "palette_trns.png": (Image.fromarray(rgb).quantize(64),
                             {"transparency": 3}),
        "grey.jpg": (Image.fromarray(a), {"quality": 90}),
        "cmyk_q90.jpg": (Image.fromarray(rgb).convert("CMYK"),
                         {"quality": 90}),
        "cmyk_q75.jpg": (Image.fromarray(_smooth(80, 64, 3, 3)).convert(
            "CMYK"), {"quality": 75}),
        "rgb.bmp": (Image.fromarray(rgb), {}),
        "rgb.tif": (Image.fromarray(rgb), {}),
        "rgb.gif": (Image.fromarray(rgb), {}),
        "rgb.webp": (Image.fromarray(rgb), {"lossless": True}),
    }
    for q in (75, 90, 95):
        for s in (0, 1, 2):  # 4:4:4, 4:2:2, 4:2:0
            kinds[f"rgb_q{q}_s{s}.jpg"] = (Image.fromarray(rgb),
                                           {"quality": q, "subsampling": s})
    out = []
    for name, (img, kw) in kinds.items():
        path = root / name
        img.save(path, **kw)
        out.append((name, str(path)))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _files(tmp_path_factory.mktemp("images"))


def test_decode_grey_matches_imread_grayscale(files):
    for name, path in files:
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        got = image_io.read_grey(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(image_io.decode_grey(f.read()),
                                          want, err_msg=name)


def test_decode_image_matches_imread_color(files):
    for name, path in files:
        want = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
        got = image_io.read_image(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("quality", [75, 90, 95])
def test_cmyk_jpeg_decodes_as_cv2(tmp_path, quality):
    """The server's codec decodes a CMYK JPEG to OpenCV's values on every
    channel: libjpeg's inverted samples through OpenCV's CMYK2BGR."""
    for seed, (h, w) in enumerate(((53, 37), (80, 64), (80, 64))):
        path = tmp_path / f"c{seed}.jpg"
        Image.fromarray(_smooth(h, w, 3, 10 + seed)).convert("CMYK").save(
            path, quality=quality)
        body = path.read_bytes()
        want = cv2.imdecode(np.frombuffer(body, np.uint8),
                            cv2.IMREAD_COLOR)[:, :, ::-1]
        np.testing.assert_array_equal(codec.decode_image(body), want)


def test_png_grey_is_libpng_rgb_to_gray(tmp_path):
    """Colours where libpng's truncating (9797, 19234, 3737) >> 15 and
    cvtColor's rounded (9798, 19235, 3735) part: the grey PNG decode is
    libpng's, as cv2's."""
    rgb = np.array([[[0, 255, 0], [1, 1, 0], [0, 1, 1], [3, 3, 2],
                     [200, 100, 50], [255, 0, 0]]], np.uint8)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    libpng = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    cvt = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    assert (libpng != cvt).sum() == 4
    path = tmp_path / "c.png"
    Image.fromarray(rgb).save(path)
    got = image_io.read_grey(str(path))
    np.testing.assert_array_equal(got, libpng)
    np.testing.assert_array_equal(got, cv2.imread(str(path),
                                                  cv2.IMREAD_GRAYSCALE))


def test_missing_and_bad_files_raise_naming_them(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    missing = tmp_path / "missing.png"
    for path in (bad, missing):
        assert cv2.imread(str(path)) is None
        for read in (image_io.read_image, image_io.read_grey):
            with pytest.raises(ValueError, match=path.name):
                read(str(path))


def test_module_imports_no_cv2_jax_or_the_jax_package():
    banned = ("cv2", "jax", "flax", "optax", "simpleaicv_tpu")
    for rel in ("data/image_io.py", "demo/codec.py"):
        for node in ast.walk(ast.parse((PORT / rel).read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (rel, name)
