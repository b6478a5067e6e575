"""The port's detection data pipeline against the JAX package's, numpy on
the CPU: ``FakeDetectionDataset`` through ``Normalize`` and
``DETRDetectionCollater`` give the same arrays, at the DINO-DETR recipe's
collater settings (yolo style, 100 annotation rows) and in retina style
with images smaller than the canvas."""

import numpy as np
import pytest

from simpleaicv_tpu.data.datasets.coco import \
    FakeDetectionDataset as JaxFakeDataset
from simpleaicv_tpu.data.detection import DETRDetectionCollater as JaxCollater
from simpleaicv_tpu.data.detection import Normalize as JaxNormalize
from simpleaicv_tpu_torch.data.datasets import FakeDetectionDataset
from simpleaicv_tpu_torch.data.detection import (DETRDetectionCollater,
                                                 Normalize)


def test_fake_dataset_matches_jax():
    kwargs = dict(num_samples=5, image_hw=96, num_classes=80, max_boxes=20)
    ours = FakeDetectionDataset(transform=Normalize(), **kwargs)
    theirs = JaxFakeDataset(transform=JaxNormalize(), **kwargs)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)
        assert a["image"].dtype == np.float32 and a["image"].max() <= 1.0
        assert 1 <= a["annots"].shape[0] <= 20


@pytest.mark.parametrize("resize,resize_type,image_hw,max_annots", [
    (96, "yolo_style", 96, 100),     # the recipe's settings, scaled down
    (64, "retina_style", 80, 3),     # a canvas of 107, rows cut to 3
])
def test_collater_matches_jax(resize, resize_type, image_hw, max_annots):
    dataset = FakeDetectionDataset(num_samples=3, image_hw=image_hw,
                                   num_classes=80, max_boxes=6,
                                   transform=Normalize())
    samples = [dataset[i] for i in range(3)]
    got = DETRDetectionCollater(resize, resize_type, max_annots)(samples)
    want = JaxCollater(resize, resize_type, max_annots)(samples)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    canvas = got["image"].shape[1]
    assert canvas == (resize if resize_type == "yolo_style"
                      else round(resize * 1333 / 800))
    # the mask marks the padding; scaled boxes are normalised and valid
    # rows carry their class
    assert (got["mask"][:, :image_hw, :image_hw] == 0).all()
    assert (got["mask"][:, image_hw:] == 1).all()
    valid = got["scaled_annots"][..., 4] >= 0
    assert ((got["scaled_annots"][..., :4][valid] > 0)
            & (got["scaled_annots"][..., :4][valid] <= 1)).all()


def test_collater_rejects_unknown_style():
    with pytest.raises(ValueError, match="resize_type"):
        DETRDetectionCollater(64, "letterbox")
