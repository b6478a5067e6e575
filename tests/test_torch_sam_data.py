"""The port's SAM data pipeline (numpy only) against the JAX package's, which
uses OpenCV: the collater on the same samples and seeds, the prior mask bit
for bit, and the numpy ellipse of the synthetic dataset against
``cv2.ellipse``."""

import random

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data import interactive_segmentation as jax_data
from simpleaicv_tpu_torch.data import interactive_segmentation as port_data

KEYS = ("image", "mask", "prompt_point", "prompt_box", "prompt_mask")


def _collate_both(samples, seed, **kwargs):
    """The JAX collater draws from the global generators, the port's from
    the ones it is given; both are seeded alike."""
    random.seed(seed)
    np.random.seed(seed)
    want = jax_data.SAMBatchCollater(**kwargs)(samples)
    got = port_data.SAMBatchCollater(
        **kwargs, rng=random.Random(seed),
        np_rng=np.random.RandomState(seed))(samples)
    return got, want


@pytest.mark.parametrize("kwargs", [
    dict(resize=64), dict(resize=96, use_noise_bbox=False),
    dict(resize=64, positive_point_num_range=(3, 5), max_points=4)])
def test_collater_matches_jax(kwargs):
    """Same samples (smaller than the canvas in one case, so padded), same
    seeds: every array equal bit for bit, the prior mask included."""
    samples = [port_data.FakeSAMSegmentationDataset(8, 64)[i]
               for i in range(4)]
    empty = {"image": np.full((64, 64, 3), 30.0, np.float32),
             "mask": np.zeros((64, 64), np.float32)}
    got, want = _collate_both(samples + [empty], seed=3, **kwargs)
    assert set(got) == set(want) == set(KEYS)
    for key in KEYS:
        assert got[key].dtype == want[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    r = kwargs["resize"]
    assert got["prompt_mask"].shape == (5, r // 4, r // 4, 1)
    assert got["prompt_mask"].flags["C_CONTIGUOUS"]
    # the empty mask gets no click and a zero box
    assert (got["prompt_point"][4] == -1).all()
    assert not got["prompt_box"][4].any()
    # clicks lie inside the mask
    for i in range(4):
        for x, y, label in got["prompt_point"][i]:
            if label >= 0:
                assert label == 1 and got["mask"][i, int(y), int(x)] == 1


def test_prior_mask_is_the_nearest_resize_by_four():
    rng = np.random.RandomState(0)
    mask = (rng.rand(128, 128) > 0.5).astype(np.float32)
    want = cv2.resize(mask, (32, 32), interpolation=cv2.INTER_NEAREST)
    got = port_data.SAMBatchCollater(resize=128)(
        [{"image": np.zeros((128, 128, 3), np.float32), "mask": mask}])
    np.testing.assert_array_equal(got["prompt_mask"][0, :, :, 0], want)


def test_collater_draws_only_from_its_own_generators():
    samples = [port_data.FakeSAMSegmentationDataset(4, 64)[i]
               for i in range(3)]
    make = lambda: port_data.SAMBatchCollater(  # noqa: E731
        resize=64, rng=random.Random(5), np_rng=np.random.RandomState(5))
    first = make()(samples)
    random.seed(99)
    np.random.seed(99)
    again = make()(samples)
    for key in KEYS:
        np.testing.assert_array_equal(first[key], again[key])
    # the generators advance: a second batch from one collater differs
    collater = make()
    collater(samples)
    assert not np.array_equal(collater(samples)["prompt_point"],
                              first["prompt_point"])


def test_collater_rejects_what_does_not_fit():
    with pytest.raises(ValueError, match="multiple of 4"):
        port_data.SAMBatchCollater(resize=66)
    big = {"image": np.zeros((80, 64, 3), np.float32),
           "mask": np.zeros((80, 64), np.float32)}
    with pytest.raises(ValueError, match="canvas"):
        port_data.SAMBatchCollater(resize=64)([big])


@pytest.mark.parametrize("seed", [0, 1])
def test_noise_bbox_matches_jax(seed):
    box = np.array([10.0, 20.0, 200.0, 90.0], np.float32)
    np.random.seed(seed)
    want = jax_data.noise_bbox(box, 128, 256)
    got = port_data.noise_bbox(box, 128, 256, np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)
    assert 0 <= got[0] < got[2] <= 256 and 0 <= got[1] < got[3] <= 128


@pytest.mark.parametrize("image_hw", [64, 256])
def test_numpy_ellipse_against_cv2(image_hw):
    """The same centre, axes and noise; ``cv2.ellipse`` also fills pixels
    that its polygon's outline touches, so the masks differ on boundary
    pixels only: every differing pixel touches the numpy mask, and there are
    fewer of them than half the mask's boundary edges. Away from them the
    images are equal."""
    ours = port_data.FakeSAMSegmentationDataset(8, image_hw)
    theirs = jax_data.FakeSAMSegmentationDataset(8, image_hw)
    assert len(ours) == len(theirs) == 8
    for idx in range(4):
        a, b = ours[idx], theirs[idx]
        assert a["image"].shape == (image_hw, image_hw, 3)
        assert a["image"].dtype == a["mask"].dtype == np.float32
        m = a["mask"] > 0
        assert m.any() and set(np.unique(a["mask"])) == {0.0, 1.0}
        differ = m != (b["mask"] > 0)
        edges = (m[1:] != m[:-1]).sum() + (m[:, 1:] != m[:, :-1]).sum()
        assert differ.sum() <= edges // 2
        near = cv2.dilate(m.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
        assert not (differ & ~near).any()
        np.testing.assert_array_equal(a["image"][~differ],
                                      b["image"][~differ])
        assert (a["image"][m] == 220.0).all()


def test_dataset_transform_is_applied():
    ds = port_data.FakeSAMSegmentationDataset(
        2, 32, transform=lambda s: dict(s, seen=True))
    assert ds[1]["seen"] and ds[1]["mask"].shape == (32, 32)
