"""The port's predictors (``simpleaicv_tpu_torch/demo/predictors.py``)
against the JAX package's (``demo/predictors.py``) on the CPU in f32: the
same seeded weights (parameters and BatchNorm statistics, through
``core/weights.py::load_jax_params``), the same non-square uint8 images,
tiny models (resnet18 trunks at 64^2, FCOS at 128^2 so that 100 boxes
survive its decode). Also: the cv2 ``INTER_NEAREST`` places of the resize
back, a ``trained_model_path`` through the port's own ``best``, and the
predictors' refusal of a card that is not there.

Tolerances, from the readings of ``python tests/test_torch_predictors.py``
(the port against JAX, beside a witness: JAX against itself with every
weight moved by 1 ulp): probabilities 6e-8 apart (witness 9.5e-7), bound
5e-6; dense detections all matched, scores 9.4e-7 relative (witness
3.5e-6), bound 1e-5; alphas 5.4e-7 in L2 (witness 2.0e-7), bound 1e-5;
label maps, YOLACT's instances, polygons (scores 2.3e-7, witness 1.2e-7)
and text equal. SOLOv2's instances: all matched, scores 6.7e-6 (with
one PyTorch thread, as the suite runs: 0.987 and 0.990 matched, 7.5e-6;
witness: 0.910 and 0.970 matched, scores 6.1e-5), bounds 0.9 and 1e-4.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simpleaicv_tpu_torch.core.checkpoint import CheckpointManager
from simpleaicv_tpu_torch.demo import predictors as port

from _torch_port import (TINY_SAM, jax_f32, jax_variables, load_jax_demo,
                         one_torch_thread, seed_both, skip_jax_init,
                         zero_fill)

PROB_ATOL = 5e-6
SCORE_RTOL = 1e-5
ALPHA_L2 = 1e-5
DETECTIONS_MATCHED = 1.0
INSTANCES_MATCHED = {"solov2": 0.9, "yolact": 1.0}
INSTANCE_SCORE_RTOL = {"solov2": 1e-4, "yolact": 1e-5}

CASES = {
    "classification": ("ClassificationPredictor", 0, dict(
        network="resnet18", num_classes=7, input_size=64)),
    "fcos": ("DetectionPredictor", 0, dict(
        network="resnet18_fcos", num_classes=5, input_size=128)),
    "retinaface": ("FaceDetectionPredictor", 0, dict(
        network="resnet18_retinaface", input_size=64)),
    "deeplab": ("SemanticSegmentationPredictor", 0, dict(
        network="resnet18_deeplabv3plus", num_classes=5, input_size=64)),
    "face_parsing": ("ParsingPredictor", 0, dict(
        network="resnet18_pfan_face_parsing", num_classes=5,
        input_size=64)),
    "salient": ("BinarySegmentationPredictor", 0, dict(
        network="resnet18_pfan_segmentation", input_size=64)),
    "matting": ("HumanMattingPredictor", 0, dict(
        network="resnet18_pfan_matting", input_size=64)),
    "solov2": ("InstanceSegmentationPredictor", 0, dict(
        network="resnet18_solov2", num_classes=4, input_size=64)),
    "yolact": ("InstanceSegmentationPredictor", 0, dict(
        network="resnet18_yolact", decoder="YOLACTDecoder", num_classes=4,
        input_size=64)),
    # the seeded map sits near 0.5 (0.45 to 0.54): these thresholds give
    # line and curved polygons where the defaults give none
    "dbnet": ("TextDetectionPredictor", 2, dict(
        network="resnet18_dbnet", input_size=64, decoder_kwargs=dict(
            hard_border_threshold=0.5, box_score_threshold=0.5))),
    "ctc": ("TextRecognitionPredictor", 0, dict(
        backbone="resnet18", input_h=32, input_w=128)),
}


def _images():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (50, 70, 3)).astype(np.uint8),
            rng.randint(0, 256, (90, 41, 3)).astype(np.uint8)]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def jax_module():
    return load_jax_demo("predictors")


def build_pair(jax_module, case):
    """(JAX predictor, port predictor, params, stats) on one draw. Neither
    side draws its own weights (the JAX ``init`` skipped, the port's
    ``init_params`` a zero fill): ``seed_both`` fills every one."""
    name, seed, kw = CASES[case]
    with skip_jax_init(jax_module):
        jp = getattr(jax_module, name)(**kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "init_params", zero_fill)
        tp = getattr(port, name)(device="cpu", dtype=torch.float32, **kw)
    return (jp, tp) + seed_both(jp, tp, seed)


@pytest.fixture(scope="module")
def pair(jax_module):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = build_pair(jax_module, case)[:2]
        return cache[case]
    return get


def _run_jax(jp, image, **kw):
    with jax_f32():
        return jp(image, **kw)


# -- the comparisons, shared with the readings of __main__ ---------------

def topk_reading(want, got):
    assert [i for i, _ in got] == [i for i, _ in want]
    return max(abs(a - b) for (_, a), (_, b) in zip(want, got))


def detections_reading(want, got, factor):
    """(share of the JAX detections matched, largest relative score gap of
    the matched): a match has the class, a box within one truncation step
    (1 / factor) and a score within 1e-4 relative of the JAX one."""
    (wb, wc, ws), (gb, gc, gs) = want, got
    assert len(wb) > 0
    free = np.ones(len(gb), bool)
    gap, matched = 0.0, 0
    for b, c, s in zip(wb, wc, ws):
        near = (free & (gc == c) & (np.abs(gs - s) <= 1e-4 * abs(s))
                & (np.abs(gb - b).max(1, initial=0) <= 1 / factor + 1e-4))
        if near.any():
            j = int(np.argmax(near))
            free[j] = False
            matched += 1
            gap = max(gap, abs(gs[j] - s) / abs(s))
    return matched / max(len(wb), len(gb)), gap


def instances_reading(want, got):
    """(share of the JAX instances matched, largest relative score gap of
    the matched): a match has the class, the same mask and a score within
    1e-4 relative. SOLOv2's points NMS keeps a cell where it equals the
    2 x 2 maximum of its neighbourhood, so neighbours within rounding of
    each other (3e-6 here) can swap the kept cell."""
    (wm, wl, ws), (gm, gl, gs) = want, got
    assert len(wm) > 0
    free = np.ones(len(gm), bool)
    gap, matched = 0.0, 0
    for m, c, s in zip(wm, wl, ws):
        for j in np.flatnonzero(free & (gl == c)
                                & (np.abs(gs - s) <= 1e-4 * abs(s))):
            if np.array_equal(gm[j], m):
                free[j] = False
                matched += 1
                gap = max(gap, abs(gs[j] - s) / abs(s))
                break
    for a in gm:
        assert a.dtype == np.uint8 and a.shape == wm[0].shape
    return matched / max(len(wm), len(gm)), gap


def polygons_reading(want, got):
    (wb, ws), (gb, gs) = want, got
    assert len(wb) == len(gb) > 0
    for a, b in zip(wb, gb):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    return float(np.max(np.abs(np.asarray(gs) - np.asarray(ws))
                        / np.abs(np.asarray(ws))))


def alpha_reading(want, got):
    assert want.shape == got.shape and got.dtype == np.float32
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the shared pre- and post-processing ----------------------------------

# sizes where F.interpolate's single-precision scale parts from cv2
NEAREST_SIZES = [(2, 82), (3, 123), (20, 52), (21, 27), (168, 40),
                 (576, 720), (64, 50)]


@pytest.mark.parametrize("src,dst", NEAREST_SIZES)
def test_nearest_indices_match_cv2(src, dst):
    column = np.arange(src, dtype=np.float32)[:, None].repeat(2, 1)
    want = cv2.resize(column, (2, dst), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(port.nearest_indices(src, dst),
                                  want[:, 0].astype(np.int64))


def test_resize_nearest_matches_cv2_where_interpolate_does_not():
    mask = np.random.RandomState(1).randint(0, 150, (21, 20)).astype(
        np.uint8)
    want = cv2.resize(mask, (52, 27), interpolation=cv2.INTER_NEAREST)
    got = port.resize_nearest(torch.from_numpy(mask), (27, 52)).numpy()
    np.testing.assert_array_equal(got, want)
    torch_nearest = F.interpolate(torch.from_numpy(mask)[None, None].float(),
                                  size=(27, 52), mode="nearest")[0, 0]
    assert (torch_nearest.numpy() != want).any()


@pytest.mark.parametrize("hw", [(50, 70), (90, 41)])
def test_square_resize_matches_cv2(hw):
    image = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(
        np.uint8)
    want = cv2.resize(image.astype(np.float32), (64, 64)) / 255.0
    got = port.square_resize(image, 64, "cpu")
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)


def test_sam_mask_resize_back_matches_cv2():
    """The SAM predictor's binary mask goes back to the image at cv2's
    nearest places: a 40 x 61 image letterboxes to (nh, nw) = (168, 256),
    and 168 -> 40 is a size where F.interpolate's nearest mode parts from
    cv2."""
    sam = port.SAMPredictor("sam_b", image_size=256, device="cpu",
                            dtype=torch.float32, **TINY_SAM)
    logits = torch.from_numpy(np.random.RandomState(2).randn(256, 256)
                              .astype(np.float32))
    got = sam._binary_mask(logits, (168, 256), (40, 61))
    binary = (logits.numpy() > 0).astype(np.uint8)[:168, :256]
    want = cv2.resize(binary, (61, 40), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(got, want)
    torch_nearest = F.interpolate(torch.from_numpy(binary)[None, None].float(),
                                  size=(40, 61), mode="nearest")[0, 0]
    assert (torch_nearest.numpy() != want).any()


# -- each predictor against the JAX one -----------------------------------

def test_classification_matches_jax(pair):
    jp, tp = pair("classification")
    for image in _images():
        want = _run_jax(jp, image, topk=7)
        got = tp(image, topk=7)
        assert topk_reading(want, got) <= PROB_ATOL
        assert tp(image, topk=3) == got[:3]


@pytest.mark.parametrize("case", ["fcos", "retinaface"])
def test_detections_match_jax(pair, case):
    jp, tp = pair(case)
    for image in _images():
        want = _run_jax(jp, image, score_threshold=0.3)
        got = tp(image, score_threshold=0.3)
        assert all(isinstance(g, np.ndarray) for g in got)
        factor = tp.input_size / max(image.shape[:2])
        share, gap = detections_reading(want, got, factor)
        assert share >= DETECTIONS_MATCHED and gap <= SCORE_RTOL


@pytest.mark.parametrize("case", ["deeplab", "face_parsing"])
def test_label_maps_match_jax(pair, case):
    jp, tp = pair(case)
    for image in _images():
        want = _run_jax(jp, image)
        got = tp(image)
        assert got.dtype == np.uint8 and got.shape == image.shape[:2]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["salient", "matting"])
def test_alphas_match_jax(pair, case):
    jp, tp = pair(case)
    for image in _images():
        assert alpha_reading(_run_jax(jp, image), tp(image)) <= ALPHA_L2


@pytest.mark.parametrize("case", ["solov2", "yolact"])
def test_instances_match_jax(pair, case):
    jp, tp = pair(case)
    for image in _images():
        want = _run_jax(jp, image, score_threshold=0.3)
        got = tp(image, score_threshold=0.3)
        assert all(m.shape == image.shape[:2] for m in got[0])
        share, gap = instances_reading(want, got)
        assert share >= INSTANCES_MATCHED[case]
        assert gap <= INSTANCE_SCORE_RTOL[case]


def test_text_polygons_match_jax(pair):
    jp, tp = pair("dbnet")
    for image in _images():
        want = _run_jax(jp, image)
        got = tp(image)
        assert polygons_reading(want, got) <= SCORE_RTOL


def test_text_matches_jax(pair):
    jp, tp = pair("ctc")
    strip = np.random.RandomState(3).randint(0, 256, (20, 150, 3)).astype(
        np.uint8)
    for image in _images() + [strip]:
        got = tp(image)
        assert isinstance(got, str) and got
        assert got == _run_jax(jp, image)


# -- checkpoints and devices ----------------------------------------------

def test_trained_model_path_loads_the_ports_best(pair, tmp_path):
    """A ``best`` written by the port's CheckpointManager (parameters and
    BatchNorm statistics) gives a predictor with another seed the same
    weights and the same label maps."""
    _, tp = pair("face_parsing")
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_best(tp.model.state_dict(), 0.5)
    _, _, kw = CASES["face_parsing"]
    loaded = port.ParsingPredictor(trained_model_path=ckpt.best_path,
                                   device="cpu", dtype=torch.float32, seed=1,
                                   **kw)
    want = tp.model.state_dict()
    got = loaded.model.state_dict()
    assert any("running_var" in k for k in got)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    fresh = port.ParsingPredictor(device="cpu", dtype=torch.float32, seed=1,
                                  **kw)
    image = _images()[0]
    np.testing.assert_array_equal(loaded(image), tp(image))
    assert not all(torch.equal(fresh.model.state_dict()[k], v)
                   for k, v in want.items())


@pytest.mark.parametrize("name", sorted({c[0] for c in CASES.values()})
                         + ["SAMPredictor"])
def test_predictors_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port, name)()


def _readings():
    """Prints each case's reading against JAX and the witness's: JAX
    against itself with every weight moved by 1 ulp."""
    module = load_jax_demo("predictors")
    for case, (name, _, kw) in CASES.items():
        jp, tp, params, stats = build_pair(module, case)
        nudged = jax_variables(
            *(None if t is None else jax.tree.map(
                lambda a: np.nextafter(a, np.float32(np.inf)), t)
              for t in (params, stats)))
        original = jp.variables
        for image in _images():
            want = _run_jax(jp, image)
            jp.variables = nudged
            witness = _run_jax(jp, image)
            jp.variables = original
            got = tp(image)
            out = []
            for other in (got, witness):
                if case == "classification":
                    out.append(topk_reading(want, other))
                elif case in ("fcos", "retinaface"):
                    out.append(detections_reading(
                        want, other, tp.input_size / max(image.shape[:2])))
                elif case in ("salient", "matting"):
                    out.append(alpha_reading(want, other))
                elif case in ("solov2", "yolact"):
                    out.append(instances_reading(want, other))
                elif case == "dbnet":
                    out.append(polygons_reading(want, other))
                elif case == "ctc":
                    out.append(other == want)
                else:
                    out.append(float(np.mean(other == want)))
            print(f"{case:15s} {image.shape[:2]} port {out[0]!r:24} "
                  f"witness {out[1]!r}", flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    _readings()
