"""The port's classification data pipeline against the JAX package's, on
the CPU: the synthetic datasets and the collater (exact), every transform
with the same seeds, the two resizes against OpenCV, and the loader's
batches and order over two epochs in thread and process modes.

Tolerances: the resizes (``RandomResizedCrop``, ``Resize``, both OpenCV's
``INTER_LINEAR`` in the JAX package) within 1e-2 on a 0..255 image (4e-5 of
the range: OpenCV computes the source coordinate in double, PyTorch in
float); everything else exact.
"""

import random

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data import transforms as jt
from simpleaicv_tpu.data.collater import \
    ClassificationCollater as JaxCollater
from simpleaicv_tpu.data.datasets import synthetic as jax_synth
from simpleaicv_tpu.data.loader import DataLoader as JaxLoader
from simpleaicv_tpu_torch.data import transforms as pt
from simpleaicv_tpu_torch.data.collater import ClassificationCollater
from simpleaicv_tpu_torch.data.datasets import (FakeClassificationDataset,
                                                LearnableClassificationDataset)
from simpleaicv_tpu_torch.data.loader import DataLoader

RESIZE_ATOL = 1e-2


def _image(seed, h=37, w=53):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(
        np.float32)


@pytest.mark.parametrize("idx", [0, 1, 17, 511])
def test_fake_dataset_exact(idx):
    kw = dict(num_samples=512, image_hw=24, num_classes=10)
    got = FakeClassificationDataset(**kw)[idx]
    want = jax_synth.FakeClassificationDataset(**kw)[idx]
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["label"] == want["label"]
    assert len(FakeClassificationDataset(**kw)) == 512


@pytest.mark.parametrize("set_name", ["train", "val"])
def test_learnable_dataset_exact(set_name):
    kw = dict(num_samples=16, image_hw=12, num_classes=3, set_name=set_name)
    port, jax_ds = (LearnableClassificationDataset(**kw),
                    jax_synth.LearnableClassificationDataset(**kw))
    for idx in (0, 4, 15):
        np.testing.assert_array_equal(port[idx]["image"],
                                      jax_ds[idx]["image"])
        assert port[idx]["label"] == jax_ds[idx]["label"]


def test_dataset_applies_transform():
    ds = FakeClassificationDataset(num_samples=4, image_hw=8,
                                   transform=pt.Normalize())
    want = jax_synth.FakeClassificationDataset(
        num_samples=4, image_hw=8, transform=jt.Normalize())
    np.testing.assert_array_equal(ds[2]["image"], want[2]["image"])


def _run(transform, image, seed, label=3):
    return transform({"image": image.copy(), "label": label})


# (name, port transform factory, JAX transform, resizes?): each factory takes
# (rng, np_rng); the deterministic ones ignore them
RANDOM = [
    ("flip", lambda r, n: pt.RandomHorizontalFlip(0.5, rng=r),
     lambda: jt.RandomHorizontalFlip(0.5), False),
    ("crop", lambda r, n: pt.RandomCrop(24, rng=r),
     lambda: jt.RandomCrop(24), False),
    ("resized_crop", lambda r, n: pt.RandomResizedCrop(20, rng=r),
     lambda: jt.RandomResizedCrop(20), True),
    ("resized_crop_fallback",
     lambda r, n: pt.RandomResizedCrop(16, scale=(2.0, 3.0), rng=r),
     lambda: jt.RandomResizedCrop(16, scale=(2.0, 3.0)), True),
    ("erasing_pixel",
     lambda r, n: pt.RandomErasing(prob=0.7, rng=r, np_rng=n),
     lambda: jt.RandomErasing(prob=0.7), False),
    ("erasing_const",
     lambda r, n: pt.RandomErasing(prob=0.7, mode="const", rng=r, np_rng=n),
     lambda: jt.RandomErasing(prob=0.7, mode="const"), False),
    ("pca_jitter", lambda r, n: pt.PCAJitter(0.1, np_rng=n),
     lambda: jt.PCAJitter(0.1), False),
]


@pytest.mark.parametrize("name,port_t,jax_t,resizes", RANDOM,
                         ids=[r[0] for r in RANDOM])
def test_random_transforms_match_jax_with_the_same_seeds(name, port_t, jax_t,
                                                         resizes):
    """The JAX transform draws from the global ``random`` and
    ``np.random``, seeded; the port's from generators seeded alike, and
    without generators from the globals: all three give the same samples
    over a sequence of draws."""
    atol = RESIZE_ATOL if resizes else 0.0
    images = [_image(s) for s in range(6)]
    random.seed(11)
    np.random.seed(12)
    jax_fn = jax_t()
    want = [_run(jax_fn, im, 0)["image"] for im in images]
    port_fn = port_t(random.Random(11), np.random.RandomState(12))
    got = [_run(port_fn, im, 0)["image"] for im in images]
    random.seed(11)
    np.random.seed(12)
    global_fn = port_t(None, None)
    got_global = [_run(global_fn, im, 0)["image"] for im in images]
    for g, gg, w in zip(got, got_global, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        np.testing.assert_array_equal(g, gg)


DETERMINISTIC = [
    ("pad_reflect", pt.Pad(4), jt.Pad(4), False),
    ("pad_const", pt.Pad(3, fill=7, padding_mode="constant"),
     jt.Pad(3, fill=7, padding_mode="constant"), False),
    ("resize_wide", pt.Resize(24), jt.Resize(24), True),
    ("resize_up", pt.Resize(96), jt.Resize(96), True),
    ("center_crop", pt.CenterCrop(20), jt.CenterCrop(20), False),
    ("center_crop_larger", pt.CenterCrop(64), jt.CenterCrop(64), False),
    ("normalize", pt.Normalize(), jt.Normalize(), False),
    ("mean_std", pt.MeanStdNormalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.25]),
     jt.MeanStdNormalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.25]), False),
    ("identity", pt.Opencv2PIL(), jt.Opencv2PIL(), False),
    ("identity_back", pt.PIL2Opencv(), jt.PIL2Opencv(), False),
    ("compose", pt.Compose([pt.Resize(40), pt.CenterCrop(32),
                            pt.Normalize()]),
     jt.Compose([jt.Resize(40), jt.CenterCrop(32), jt.Normalize()]), True),
]


@pytest.mark.parametrize("name,port_t,jax_t,resizes", DETERMINISTIC,
                         ids=[d[0] for d in DETERMINISTIC])
def test_deterministic_transforms_match_jax(name, port_t, jax_t, resizes):
    for image in (_image(1), _image(2, 60, 41)):
        got = _run(port_t, image, 0)
        want = _run(jax_t, image, 0)
        assert got["image"].shape == want["image"].shape
        assert got["label"] == want["label"]
        np.testing.assert_allclose(got["image"], want["image"],
                                   atol=RESIZE_ATOL if resizes else 0.0,
                                   rtol=0)


def test_torch_aliases():
    assert pt.TorchRandomResizedCrop is pt.RandomResizedCrop
    assert pt.TorchResize is pt.Resize and pt.TorchPad is pt.Pad
    assert pt.TorchCenterCrop is pt.CenterCrop
    assert pt.TorchRandomCrop is pt.RandomCrop
    assert pt.TorchRandomHorizontalFlip is pt.RandomHorizontalFlip
    assert pt.TorchMeanStdNormalize is pt.MeanStdNormalize


@pytest.mark.parametrize("src,dst", [
    ((256, 256), (224, 224)), ((64, 64), (32, 32)), ((37, 53), (224, 224)),
    ((300, 200), (256, 171)), ((17, 23), (40, 31)), ((5, 7), (3, 11)),
    ((224, 224), (224, 224))])
def test_resize_matches_opencv(src, dst):
    """Up- and down-scales, odd sizes and the identity, the border rows and
    columns included (both clamp the source index at the edge)."""
    image = _image(sum(src) + sum(dst), *src)
    got = pt.resize_bilinear(image, *dst)
    want = cv2.resize(image, (dst[1], dst[0]),
                      interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape == (*dst, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[[0, -1]], want[[0, -1]],
                               atol=RESIZE_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]],
                               atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, "uint8"])
def test_collater_exact(dtype):
    samples = [{"image": _image(i, 8, 8), "label": i} for i in range(5)]
    got = ClassificationCollater(image_dtype=dtype)(samples)
    want = JaxCollater(image_dtype=dtype)(samples)
    assert got["image"].dtype == want["image"].dtype
    assert got["label"].dtype == want["label"].dtype == np.int32
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["label"], want["label"])


def _epochs(loader, epochs=(1, 2)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_matches_jax_over_two_epochs(worker_mode, drop_last):
    """37 samples in batches of 8: 4 batches, or 5 with the remainder of 5;
    the per-epoch shuffle ``RandomState(seed + epoch)``, the same batches in
    the same order as the JAX loader's."""
    kw = dict(batch_size=8, shuffle=True, drop_last=drop_last,
              num_workers=2, seed=3, worker_mode=worker_mode)
    port = DataLoader(FakeClassificationDataset(37, 6, 10),
                      collater=ClassificationCollater(), **kw)
    jax_loader = JaxLoader(jax_synth.FakeClassificationDataset(37, 6, 10),
                           collater=JaxCollater(), **kw)
    assert len(port) == len(jax_loader) == (4 if drop_last else 5)
    got, want = _epochs(port), _epochs(jax_loader)
    assert [len(e) for e in got] == [len(port)] * 2
    for epoch_got, epoch_want in zip(got, want):
        for b_got, b_want in zip(epoch_got, epoch_want):
            np.testing.assert_array_equal(b_got["image"], b_want["image"])
            np.testing.assert_array_equal(b_got["label"], b_want["label"])
    # the two epochs are shuffled differently
    assert not np.array_equal(got[0][0]["label"], got[1][0]["label"]) or \
        not np.array_equal(got[0][0]["image"], got[1][0]["image"])


def _augmented_batches(seed, epoch):
    """The batches of one process-mode epoch over tiny images whose
    transforms draw from the workers' global ``random`` and ``numpy.random``
    (no generator is passed, as in the experiment configs)."""
    transform = pt.Compose([pt.RandomHorizontalFlip(prob=0.5),
                            pt.RandomErasing(prob=0.9)])
    loader = DataLoader(FakeClassificationDataset(8, 6, 10, transform), 2,
                        ClassificationCollater(), shuffle=False,
                        num_workers=2, seed=seed, worker_mode="process")
    loader.set_epoch(epoch)
    return np.stack([b["image"] for b in loader])


def test_process_workers_are_seeded_per_epoch():
    """Two seeded runs give the same batches; another seed or another epoch
    gives other ones."""
    first = _augmented_batches(seed=5, epoch=1)
    np.testing.assert_array_equal(first, _augmented_batches(seed=5, epoch=1))
    assert not np.array_equal(first, _augmented_batches(seed=6, epoch=1))
    assert not np.array_equal(first, _augmented_batches(seed=5, epoch=2))


def test_loader_without_shuffle_keeps_the_order():
    loader = DataLoader(FakeClassificationDataset(10, 4, 10), 4,
                        ClassificationCollater(), shuffle=False,
                        drop_last=False, num_workers=3)
    labels = np.concatenate([b["label"] for b in loader])
    ds = FakeClassificationDataset(10, 4, 10)
    np.testing.assert_array_equal(labels, [ds[i]["label"] for i in range(10)])


class _Failing(FakeClassificationDataset):

    def __getitem__(self, idx):
        if idx == 5:
            raise KeyError("sample 5 is broken")
        return super().__getitem__(idx)


def test_loader_raises_a_dataset_error_in_the_consumer():
    loader = DataLoader(_Failing(12, 4, 10), 4, ClassificationCollater(),
                        shuffle=False, num_workers=2)
    with pytest.raises(KeyError, match="sample 5 is broken"):
        list(loader)


def test_loader_consumer_may_stop_early():
    """Leaving after one batch of many neither hangs nor leaks a blocked
    producer: the next epoch runs to its end."""
    loader = DataLoader(FakeClassificationDataset(64, 4, 10), 2,
                        ClassificationCollater(), num_workers=2, prefetch=1)
    for _ in loader:
        break
    assert len(list(loader)) == 32


def test_loader_checks_its_mode():
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(FakeClassificationDataset(4, 4, 10), 2,
                   ClassificationCollater(), worker_mode="fiber")
