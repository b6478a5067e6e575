"""The port's SAMPredictor against the JAX package's (demo/predictors.py) on
the same seeded weights: point, box and drawn-region requests to
non-square images, in f32 on the CPU. Also: the port imports no JAX, and
its entry points refuse to run on a CUDA device that is not there."""

import importlib.util
import os
import subprocess
import sys

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu_torch.core.weights import load_jax_params
from simpleaicv_tpu_torch.demo import predictors as port_predictors
from simpleaicv_tpu_torch.demo.predictors import SAMPredictor

from _torch_port import TINY_SAM, jax_f32, random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 256


def _jax_predictors():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_predictors", os.path.join(REPO, "demo", "predictors.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def predictors():
    """The JAX and the port's SAM predictors at 256^2 on one set of seeded
    weights."""
    with jax_f32():
        jp = _jax_predictors().SAMPredictor("sam_b", image_size=IMG,
                                            **TINY_SAM)
    params = random_params(jp.variables["params"], seed=3)
    jp.variables = {"params": jax.tree.map(jnp.asarray, params)}
    tp = SAMPredictor("sam_b", image_size=IMG, device="cpu",
                      dtype=torch.float32, **TINY_SAM)
    load_jax_params(tp.model, params)
    return jp, tp


def _image(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _cv2_canvas(image, s):
    """The JAX predictor's letterbox, with cv2."""
    h, w = image.shape[:2]
    factor = s / max(h, w)
    nh, nw = int(round(h * factor)), int(round(w * factor))
    canvas = np.zeros((s, s, 3), np.float32)
    canvas[:nh, :nw] = cv2.resize(image.astype(np.float32), (nw, nh)) / 255.0
    return canvas


@pytest.mark.parametrize("h,w", [(120, 160), (300, 200), (256, 100)])
def test_letterbox_matches_cv2(h, w):
    image = _image(h, w, seed=h)
    canvas, _, _ = port_predictors.letterbox(image, IMG, "cpu")
    np.testing.assert_allclose(canvas.numpy(), _cv2_canvas(image, IMG),
                               atol=1e-4)


def _agree(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert np.mean(a == b) >= 0.999, np.mean(a == b)


def test_point_requests_match_jax(predictors):
    jp, tp = predictors
    image = _image(120, 160, seed=1)
    points = [(50.0, 60.0), (130.0, 20.0)]
    with jax_f32():
        want = jp(image, points)
        pts = np.full((1, 9, 3), -1.0, np.float32)
        factor = IMG / 160
        pts[0, :2] = [[x * factor, y * factor, 1.0] for x, y in points]
        want_logits = np.asarray(jp._forward(
            jp.variables, jnp.asarray(_cv2_canvas(image, IMG)[None]),
            jnp.asarray(pts)))[0]
    logits, _ = tp.mask_logits(image, points_xy=points)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-3,
                               rtol=1e-3)
    _agree(tp(image, points), want)


def test_box_and_region_requests_match_jax(predictors):
    jp, tp = predictors
    image = _image(300, 200, seed=2)
    region = np.zeros((300, 200, 3), np.uint8)
    region[40:210, 30:150] = (255, 0, 0)
    with jax_f32():
        want_box = jp.predict_box(image, (20, 40, 150, 260))
        want_region = jp.predict_region(image, region)
    _agree(tp.predict_box(image, (20, 40, 150, 260)), want_box)
    _agree(tp.predict_region(image, region), want_region)


def test_bounding_rect_and_gray_match_cv2():
    rng = np.random.RandomState(4)
    for _ in range(5):
        m = (rng.rand(40, 60) > 0.995).astype(np.uint8)
        assert port_predictors.bounding_rect(m) == cv2.boundingRect(m)
    assert port_predictors.bounding_rect(np.zeros((4, 4), np.uint8)) == \
        cv2.boundingRect(np.zeros((4, 4), np.uint8))
    rgb = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    rgb[0, :3] = [(1, 0, 0), (0, 0, 4), (2, 1, 1)]
    np.testing.assert_array_equal(port_predictors._rgb_to_gray_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import simpleaicv_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'simpleaicv_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SAMPredictor()
