"""The port's segmentation data pipelines (no OpenCV) against the JAX
package's (OpenCV), on the CPU: the synthetic dataset and both collaters
bit-exact; each resize within 1e-2 on a 0..255 image (``F.interpolate``
against OpenCV's ``INTER_LINEAR``) with the mask exact (nearest
neighbour); each seeded random transform drawing the same crop, flip and
jitter from the same global ``random`` or ``numpy.random`` state; the
8-bit HSV conversion exact forward and within one level back."""

import random

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data import binary_segmentation as jax_bseg
from simpleaicv_tpu.data import segmentation as jax_seg
from simpleaicv_tpu_torch.data import binary_segmentation as bseg
from simpleaicv_tpu_torch.data import segmentation as seg

from _torch_port import one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _sample(hw=(48, 64), seed=0, classes=6):
    """An image on 0..255 and a mask with rectangles of classes and an
    ignored strip."""
    rng = np.random.RandomState(seed)
    h, w = hw
    image = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.int32)
    for _ in range(4):
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        mask[y:y + rng.randint(4, h // 2), x:x + rng.randint(4, w // 2)] = \
            rng.randint(1, classes)
    mask[-3:] = 255
    return {"image": image, "mask": mask, "scale": np.float32(1.0),
            "size": np.array([h, w], np.float32)}


def _copy(sample):
    return {k: np.array(v, copy=True) for k, v in sample.items()}


def _assert_resized_alike(got, want):
    """Images within 1e-2 on 0..255, masks equal, the rest equal."""
    assert set(got) == set(want)
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-2)
    assert got["mask"].dtype == want["mask"].dtype
    np.testing.assert_array_equal(got["mask"], want["mask"])
    for key in set(want) - {"image", "mask"}:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("num_classes,hw", [(6, 64), (150, 96)])
def test_fake_dataset_is_bit_exact(num_classes, hw):
    got = seg.FakeSegmentationDataset(4, hw, num_classes)
    want = jax_seg.FakeSegmentationDataset(4, hw, num_classes)
    assert len(got) == len(want) == 4
    for i in range(4):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("ignore_index", [255, None])
def test_semantic_collater_is_bit_exact(ignore_index):
    samples = [_sample((40, 56), 0), _sample((64, 30), 1)]
    got = seg.SemanticSegmentationCollater(64, ignore_index)(
        [_copy(s) for s in samples])
    want = jax_seg.SemanticSegmentationCollater(64, ignore_index)(samples)
    assert set(got) == set(want) == {"image", "mask", "size"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_binary_collater_is_bit_exact():
    samples = [_sample((40, 56), 0), _sample((64, 30), 1)]
    for s in samples:
        s["mask"] = (s["mask"] > 0).astype(np.float32)
    got = bseg.BinarySegCollater(64)([_copy(s) for s in samples])
    want = jax_bseg.BinarySegCollater(64)(samples)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("hw,resize", [((48, 64), 96), ((120, 90), 64),
                                       ((33, 50), 50)])
def test_seg_resize_matches_jax(hw, resize):
    sample = _sample(hw)
    _assert_resized_alike(seg.SegResize(resize)(_copy(sample)),
                          jax_seg.SegResize(resize)(sample))


@pytest.mark.parametrize("hw,resize", [((48, 64), 96), ((120, 90), 64)])
def test_binary_resize_matches_jax(hw, resize):
    sample = _sample(hw)
    sample["mask"] = (sample["mask"] > 0).astype(np.float32)
    _assert_resized_alike(bseg.BinarySegResize(resize)(_copy(sample)),
                          jax_bseg.BinarySegResize(resize)(sample))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_crop_resize_matches_jax(seed):
    """The same scale ratio and crop (with its category-ratio retries) from
    the same ``random`` state, at a quarter of the ADE20K recipe's sizes:
    long side 512 x (0.5 to 2.0), 128^2 crops."""
    args = dict(image_scale=(512, 128), multi_scale_range=(0.5, 2.0),
                crop_size=(128, 128))
    sample = _sample((96, 128), seed)
    random.seed(seed)
    got = seg.SegRandomCropResize(**args)(_copy(sample))
    after = random.random()
    random.seed(seed)
    want = jax_seg.SegRandomCropResize(**args)(sample)
    assert random.random() == after   # the same number of draws
    _assert_resized_alike(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_flips_match_jax(seed):
    sample = _sample()
    for port, jax_t, seeder in (
            (seg.SegRandomHorizontalFlip(), jax_seg.SegRandomHorizontalFlip(),
             random.seed),
            (bseg.BinarySegRandomHorizontalFlip(),
             jax_bseg.BinarySegRandomHorizontalFlip(), np.random.seed)):
        for _ in range(3):
            seeder(seed)
            got = port(_copy(sample))
            seeder(seed)
            want = jax_t(_copy(sample))
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
            seed += 1


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_photometric_distortion_matches_jax(seed):
    """The same jitter from the same ``random`` state; the 8-bit HSV round
    trip within one level of OpenCV's."""
    sample = _sample((40, 52), seed)
    random.seed(seed)
    got = seg.SegPhotoMetricDistortion()(_copy(sample))
    after = random.random()
    random.seed(seed)
    want = jax_seg.SegPhotoMetricDistortion()(_copy(sample))
    assert random.random() == after
    assert got["image"].dtype == want["image"].dtype == np.float32
    np.testing.assert_allclose(got["image"], want["image"], atol=1.0)
    np.testing.assert_array_equal(got["mask"], want["mask"])


def test_rgb_to_hsv_is_opencvs_for_every_colour():
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                               np.arange(256), indexing="ij"), -1).reshape(
        4096, 4096, 3).astype(np.uint8)
    np.testing.assert_array_equal(seg.rgb_to_hsv_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_is_within_one_level_of_opencvs():
    """Every (H < 180, S, V): within one level; OpenCV's vector code and
    numpy's f32 part on 5e-5 of the values."""
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256),
                               np.arange(256), indexing="ij"), -1).reshape(
        180 * 256, 256, 3).astype(np.uint8)
    got = seg.hsv_to_rgb_u8(hsv).astype(np.int32)
    want = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


def test_normalizes_match_jax():
    sample = _sample()
    got = seg.SegNormalize()(_copy(sample))
    want = jax_seg.SegNormalize()(_copy(sample))
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
    got = bseg.BinarySegNormalize()(_copy(sample))
    want = jax_bseg.BinarySegNormalize()(_copy(sample))
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(got["image"], want["image"])
