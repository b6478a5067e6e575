"""The port's resizes and detection augmentations (no OpenCV) against the
JAX package's, which use OpenCV, numpy on the CPU: ``SamResize`` and
``DetectionResize`` (the image within 1e-2 on a 0..255 image, against cv2
itself and through the JAX transforms; masks, boxes, 'scale' and 'size'
exact), the flip, crop and translate with the global generators seeded
alike (exact), ``DetectionCollater`` (exact), and the DINO-DETR recipe's
train transforms end to end."""

import random

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data import detection as jax_det
from simpleaicv_tpu.data import interactive_segmentation as jax_sam
from simpleaicv_tpu.data.datasets.coco import \
    FakeDetectionDataset as JaxFakeDataset
from simpleaicv_tpu.data.transforms import Compose as JaxCompose
from simpleaicv_tpu_torch.data import detection as port_det
from simpleaicv_tpu_torch.data import interactive_segmentation as port_sam
from simpleaicv_tpu_torch.data.datasets import FakeDetectionDataset
from simpleaicv_tpu_torch.data.transforms import Compose

IMAGE_ATOL = 1e-2  # on 0..255, the classification resizes' bound against cv2


def _image(h, w, seed):
    return np.random.RandomState(seed).uniform(0, 255, (h, w, 3)).astype(
        np.float32)


def _annots(h, w, n, seed):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, w * 0.6, n)
    y1 = rng.uniform(0, h * 0.6, n)
    bw = rng.uniform(2, w * 0.4, n)
    bh = rng.uniform(2, h * 0.4, n)
    cls = rng.randint(0, 80, n)
    return np.stack([x1, y1, x1 + bw, y1 + bh, cls], 1).astype(np.float32)


def _same(got, want, image_atol=0.0):
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key == "image" and image_atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=image_atol,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("hw,resize", [((100, 37), 64), ((48, 80), 64),
                                       ((64, 64), 64), ((30, 20), 64),
                                       ((480, 640), 256)])
def test_sam_resize_matches_cv2_and_jax(hw, resize):
    h, w = hw
    image = _image(h, w, 0)
    mask = (np.random.RandomState(1).rand(h, w) > 0.5).astype(np.float32)
    got = port_sam.SamResize(resize)({"image": image.copy(),
                                      "mask": mask.copy()})
    want = jax_sam.SamResize(resize)({"image": image.copy(),
                                      "mask": mask.copy()})
    _same(got, want, IMAGE_ATOL)
    nh, nw = got["mask"].shape
    assert max(nh, nw) == resize
    np.testing.assert_allclose(
        got["image"], cv2.resize(image, (nw, nh)), rtol=0, atol=IMAGE_ATOL)
    np.testing.assert_array_equal(got["mask"], cv2.resize(
        mask, (nw, nh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("kwargs,hw", [
    (dict(resize=96, resize_type="yolo_style"), (120, 70)),
    (dict(resize=96, resize_type="yolo_style", multi_scale=True), (64, 64)),
    (dict(resize=64, resize_type="retina_style"), (90, 50)),
    (dict(resize=64, resize_type="retina_style", multi_scale=True,
          multi_scale_range=(0.5, 1.0)), (50, 140)),
])
def test_detection_resize_matches_cv2_and_jax(kwargs, hw):
    """Four samples each; with multi_scale the size is drawn from
    numpy.random, seeded alike on both sides."""
    h, w = hw
    for i in range(4):
        sample = {"image": _image(h, w, i), "annots": _annots(h, w, 3, i),
                  "scale": np.float32(1.0)}
        np.random.seed(i)
        got = port_det.DetectionResize(**kwargs)(
            {k: np.copy(v) for k, v in sample.items()})
        np.random.seed(i)
        want = jax_det.DetectionResize(**kwargs)(
            {k: np.copy(v) for k, v in sample.items()})
        _same(got, want, IMAGE_ATOL)
        nh, nw = got["image"].shape[:2]
        assert tuple(got["size"]) == (nh, nw)
        np.testing.assert_allclose(got["image"], cv2.resize(
            sample["image"], (nw, nh)), rtol=0, atol=IMAGE_ATOL)


@pytest.mark.parametrize("name,prob", [
    ("RandomHorizontalFlip", 0.5), ("RandomCrop", 0.5),
    ("RandomTranslate", 0.5), ("RandomTranslate", 1.0)])
def test_augmentations_match_jax_exactly(name, prob):
    """Eight samples through each side's transform with the global random
    seeded alike before each: every array equal (the translate's image
    against cv2.warpAffine's)."""
    for i in range(8):
        sample = {"image": _image(72, 96, i),
                  "annots": _annots(72, 96, 1 + i % 3, i),
                  "scale": np.float32(1.0),
                  "size": np.array([72, 96], np.float32)}
        random.seed(i)
        got = getattr(port_det, name)(prob)(
            {k: np.copy(v) for k, v in sample.items()})
        after = random.random()
        random.seed(i)
        want = getattr(jax_det, name)(prob)(
            {k: np.copy(v) for k, v in sample.items()})
        assert random.random() == after  # the same number of draws
        _same(got, want)


def test_translate_moved_the_image():
    """At prob 1 some sample really moved, by whole pixels."""
    moved = 0
    for i in range(8):
        image = _image(72, 96, i)
        random.seed(i)
        out = port_det.RandomTranslate(1.0)({
            "image": image, "annots": _annots(72, 96, 1, i)})["image"]
        moved += not np.array_equal(out, image)
    assert moved


@pytest.mark.parametrize("resize,resize_type,max_annots", [
    (96, "yolo_style", 100), (64, "retina_style", 2)])
def test_detection_collater_matches_jax(resize, resize_type, max_annots):
    samples = [{"image": _image(60 + 7 * i, 90 - 9 * i, i),
                "annots": _annots(60, 60, i, i),
                "scale": np.float32(0.5 + i),
                "size": np.array([60 + 7 * i, 90 - 9 * i], np.float32)}
               for i in range(4)]
    got = port_det.DetectionCollater(resize, resize_type,
                                     max_annots)(samples)
    want = jax_det.DetectionCollater(resize, resize_type,
                                     max_annots)(samples)
    _same(got, want)


def test_recipe_train_transforms_match_jax():
    """The res50_dinodetr_yoloresize1024 recipe's train transforms (yolo
    style with multi_scale, flip, crop, Normalize), cut to 128^2, over the
    synthetic dataset and the DETR collater, with the global generators
    seeded alike: the image within 1e-2 / 255, everything else exact."""

    def pipeline(mod, compose):
        return compose([
            mod.DetectionResize(resize=128, resize_type="yolo_style",
                                multi_scale=True),
            mod.RandomHorizontalFlip(prob=0.5), mod.RandomCrop(prob=0.5),
            mod.Normalize()])

    kwargs = dict(num_samples=6, image_hw=100, num_classes=80)
    ours = FakeDetectionDataset(transform=pipeline(port_det, Compose),
                                **kwargs)
    theirs = JaxFakeDataset(transform=pipeline(jax_det, JaxCompose),
                            **kwargs)
    random.seed(5)
    np.random.seed(5)
    got = port_det.DETRDetectionCollater(128)([ours[i] for i in range(6)])
    random.seed(5)
    np.random.seed(5)
    want = jax_det.DETRDetectionCollater(128)([theirs[i] for i in range(6)])
    _same(got, want, IMAGE_ATOL / 255.0)
