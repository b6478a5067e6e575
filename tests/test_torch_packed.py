"""The port's packed cache (``simpleaicv_tpu_torch/data/packed.py``,
``packed_tasks.py``, ``native_io.gather_records``) and the Trainer's packed
branches against the JAX package's, on the CPU:

* the packs of both packages' ``PackWriter`` and ``pack_dataset`` equal
  byte for byte (header, NUL padding, aligned fields), and each package
  reads the other's;
* ``PackedLoader`` batches, in order, equal to the JAX loader's for the
  same seed and epochs, through the prefetch thread, and an error in the
  collate raised in the consumer;
* the native record gather equal to numpy indexing (its plain version)
  for several dtypes, shapes and thread counts;
* ``pack_image_folder`` on JPEGs: each record the libjpeg decode of its
  file, a file that does not decode zero-filled, counted and warned;
* the detection and SAM packs against the JAX writers: annotations,
  scales, sizes, mask bits, boxes and click candidates equal; the uint8
  canvases within one level of the JAX package's ``cv2.resize`` on at most
  0.1% of the pixels (read: one level on 2.4e-5 of the pixels of 20
  detection canvases at 64^2, none on the SAM canvases); the collates
  equal;
* the Trainer sending each kind of train set where the JAX Trainer sends
  it (``simpleaicv_tpu/core/trainer.py:136-168``), and an epoch of a
  ``PackedDataset`` through the ``PackedLoader``.
"""

import os
import warnings

import cv2
import numpy as np
import pytest
import torch

from simpleaicv_tpu.data import packed as jax_packed
from simpleaicv_tpu.data import packed_tasks as jax_tasks
from simpleaicv_tpu_torch.core.trainer import Trainer, train_loader
from simpleaicv_tpu_torch.data import native_io, packed, packed_tasks
from simpleaicv_tpu_torch.data.collater import ClassificationCollater
from simpleaicv_tpu_torch.data.datasets import FakeClassificationDataset
from simpleaicv_tpu_torch.data.interactive_segmentation import \
    FakeSAMSegmentationDataset
from simpleaicv_tpu_torch.data.loader import DataLoader
from simpleaicv_tpu_torch.data.mixupcutmix import \
    MixupCutmixClassificationCollater
from simpleaicv_tpu_torch.losses import CELoss
from simpleaicv_tpu_torch.tasks import classification as port_task

from _torch_port import TinyClassifier, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


class _Extra:
    """FakeClassificationDataset samples with a float vector, a bool mask
    and a text field (which no pack keeps)."""

    def __init__(self, n, hw):
        self.base = FakeClassificationDataset(n, hw, num_classes=7)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        s = dict(self.base[i])
        rng = np.random.RandomState(100 + i)
        s["vec"] = rng.randn(5).astype(np.float32)
        s["flag"] = rng.rand(3) > 0.5
        s["score"] = float(rng.rand())
        s["path"] = f"sample_{i}.jpg"
        return s


def _pack_both(tmp_path, ds, **kw):
    port = str(tmp_path / "port.pack")
    jax = str(tmp_path / "jax.pack")
    packed.pack_dataset(ds, port, **kw)
    jax_packed.pack_dataset(ds, jax, **kw)
    return port, jax


def test_packs_are_byte_identical_and_cross_read(tmp_path):
    ds = _Extra(13, 12)
    port, jax = _pack_both(tmp_path, ds, meta={"class_names": list("abcdefg"),
                                               "source": "fake"})
    a, b = open(port, "rb").read(), open(jax, "rb").read()
    assert len(a) == len(b) and len(a) % 4096 == 0
    assert a == b
    for reader, writer in ((packed.PackReader, jax), (jax_packed.PackReader,
                                                      port)):
        r = reader(writer)
        assert len(r) == 13 and r.meta["source"] == "fake"
        assert set(r.arrays) == {"image", "label", "vec", "flag", "score"}
        for i in (0, 7, 12):
            s = ds[i]
            got = r.read_sample(i)
            np.testing.assert_array_equal(got["image"], np.clip(np.round(
                s["image"]), 0, 255).astype(np.uint8))
            assert got["label"] == s["label"]
            np.testing.assert_array_equal(got["vec"], s["vec"])
            np.testing.assert_array_equal(got["flag"], s["flag"])
            assert got["score"] == np.float32(s["score"])
    # a PackWriter's fields written out of order and by index
    fields = {"x": ((2, 3), "float64"), "y": ((), "int16")}
    for mod, name in ((packed, "p2"), (jax_packed, "j2")):
        with mod.PackWriter(str(tmp_path / name), fields, 3) as w:
            for i in (2, 0, 1):
                w.add({"x": np.full((2, 3), i, np.float64),
                       "y": np.int16(-i)}, index=i)
    assert (tmp_path / "p2").read_bytes() == (tmp_path / "j2").read_bytes()


def test_packed_dataset_view_matches_jax(tmp_path):
    port, _ = _pack_both(tmp_path, FakeClassificationDataset(6, 8))
    a, b = packed.PackedDataset(port), jax_packed.PackedDataset(port)
    for i in range(6):
        sa, sb = a[i], b[i]
        assert sa.keys() == sb.keys() and sa["label"] == sb["label"]
        assert sa["image"].dtype == np.float32
        np.testing.assert_array_equal(sa["image"], sb["image"])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_packed_loader_batches_equal_the_jax_loader(tmp_path, shuffle,
                                                    drop_last):
    port, _ = _pack_both(tmp_path, _Extra(23, 8))

    def collate(b):
        return {**b, "image": b["image"].astype(np.float32) / 2}

    mine = packed.PackedLoader(port, 5, shuffle=shuffle, drop_last=drop_last,
                               seed=3, n_threads=2, collate=collate)
    theirs = jax_packed.PackedLoader(port, 5, shuffle=shuffle,
                                     drop_last=drop_last, seed=3,
                                     collate=collate)
    assert len(mine) == len(theirs) == (4 if drop_last else 5)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    labels = [b["label"] for b in mine]
    assert sum(len(x) for x in labels) == (20 if drop_last else 23)


def test_packed_loader_raises_a_collate_error_in_the_consumer(tmp_path):
    port, _ = _pack_both(tmp_path, FakeClassificationDataset(8, 4))

    def bad(b):
        raise KeyError("no such field")

    with pytest.raises(KeyError, match="no such field"):
        list(packed.PackedLoader(port, 2, collate=bad))
    # stopping early leaves no producer behind
    it = iter(packed.PackedLoader(port, 2))
    next(it)
    it.close()


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (8, 8, 3)),
                                         (np.float32, (5,)),
                                         (np.int16, ()), (np.bool_, (3, 2))])
def test_native_gather_equals_numpy(dtype, shape):
    rng = np.random.RandomState(0)
    base = (rng.rand(50, *shape) * 100).astype(dtype)
    for n_threads in (1, 4):
        for idx in (rng.randint(0, 50, 17), np.array([49, 0, 0, 3]),
                    np.arange(50)[::-1], np.array([], np.int64)):
            got = native_io.gather_records(base, idx, n_threads=n_threads)
            want = native_io.gather_records_plain(base, idx)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    out = np.empty((2, *shape), dtype)
    assert native_io.gather_records(base, [1, 2], out=out) is out
    with pytest.raises(IndexError):
        native_io.gather_records(base, [50])
    with pytest.raises(ValueError):
        native_io.gather_records(base[:, None][::2], [0])


def _jpeg_folder(root, sizes, seed=0):
    """One class folder per entry of ``sizes``, two JPEGs each, written by
    cv2 (BGR order on disk, RGB in the pixels returned)."""
    rng = np.random.RandomState(seed)
    files = []
    for c, (h, w) in enumerate(sizes):
        os.makedirs(root / f"class{c}", exist_ok=True)
        for j in range(2):
            img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(
                np.uint8), (5, 5), 1.5)
            path = root / f"class{c}" / f"{j}.jpg"
            cv2.imwrite(str(path), img)
            files.append((str(path), c))
    return files


def test_pack_image_folder_records_the_libjpeg_decode(tmp_path):
    files = _jpeg_folder(tmp_path / "folder", [(40, 56), (70, 30)])
    (tmp_path / "folder/class1/broken.jpg").write_bytes(b"not a jpeg")
    out = str(tmp_path / "f.pack")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        packed.pack_image_folder(str(tmp_path / "folder"), out, image_hw=32,
                                 batch=2)
    assert any("1/5 images failed" in str(w.message) for w in caught)
    r = packed.PackReader(out)
    assert r.meta["decode_failures"] == 1
    assert r.meta["class_names"] == ["class0", "class1"]
    order = sorted(files + [(str(tmp_path / "folder/class1/broken.jpg"), 1)])
    for i, (path, label) in enumerate(order):
        s = r.read_sample(i)
        assert s["label"] == label
        if path.endswith("broken.jpg"):
            assert not s["image"].any()
            continue
        with open(path, "rb") as f:
            want = native_io.decode_resize(f.read(), 32, letterbox=False)
        np.testing.assert_array_equal(s["image"], np.floor(want + 0.5))


class _Detections:
    def __init__(self, n=3):
        rng = np.random.RandomState(5)
        self.samples = []
        for i in range(n):
            h, w = rng.randint(30, 90, 2)
            k = rng.randint(0, 4)
            xy = rng.rand(k, 2) * [w / 2, h / 2]
            annots = np.concatenate([xy, xy + [w / 3, h / 3],
                                     rng.randint(0, 5, (k, 1))], 1)
            self.samples.append({"image": rng.rand(h, w, 3) * 255,
                                 "annots": annots.astype(np.float32),
                                 "scale": 1.0 + i})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _assert_canvas_close(got, want):
    """uint8 canvases within one level, on at most 0.1% of the pixels."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
        diff.max(), (diff > 0).mean())


def test_detection_pack_matches_jax(tmp_path):
    ds = _Detections()
    packed_tasks.pack_detection_dataset(ds, str(tmp_path / "p"), image_hw=64,
                                        max_annots=6)
    jax_tasks.pack_detection_dataset(ds, str(tmp_path / "j"), image_hw=64,
                                     max_annots=6)
    a, b = packed.PackReader(str(tmp_path / "p")), packed.PackReader(
        str(tmp_path / "j"))
    assert a.meta == b.meta
    for name in ("annots", "scale", "size"):
        np.testing.assert_array_equal(a.arrays[name], b.arrays[name])
    _assert_canvas_close(np.asarray(a.arrays["image"]),
                         np.asarray(b.arrays["image"]))
    batch = a.read_batch([2, 0])
    got = packed_tasks.PackedDetectionCollate()(batch)
    want = jax_tasks.PackedDetectionCollate()(batch)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_sam_pack_matches_jax(tmp_path):
    base = FakeSAMSegmentationDataset(3, 96)
    ds = [{"image": base[i]["image"][:, 10:], "mask": base[i]["mask"][:, 10:]}
          for i in range(3)]
    packed_tasks.pack_sam_dataset(ds, str(tmp_path / "p"), image_hw=64,
                                  max_point_candidates=8, seed=2)
    jax_tasks.pack_sam_dataset(ds, str(tmp_path / "j"), image_hw=64,
                               max_point_candidates=8, seed=2)
    a, b = packed.PackReader(str(tmp_path / "p")), packed.PackReader(
        str(tmp_path / "j"))
    for name in ("mask_bits", "box", "point_candidates", "scale"):
        np.testing.assert_array_equal(a.arrays[name], b.arrays[name])
    _assert_canvas_close(np.asarray(a.arrays["image"]),
                         np.asarray(b.arrays["image"]))
    batch = a.read_batch([0, 1, 2])
    outs = []
    for mod in (packed_tasks, jax_tasks):
        np.random.seed(9)
        outs.append(mod.PackedSAMCollate(max_points=4, seed=1)(batch))
    for k in outs[1]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


class _Config:
    batch_size = 4
    num_workers = 2

    def __init__(self, **fields):
        self.__dict__.update(fields)


def test_trainer_routes_train_sets_as_the_jax_trainer(tmp_path):
    path = str(tmp_path / "c.pack")
    packed.pack_dataset(FakeClassificationDataset(12, 8, 3), path)
    pds = packed.PackedDataset(path)

    def first(loader):
        return next(iter(loader))

    cases = [
        (dict(train_collater=None), packed.PackedLoader, np.float32),
        (dict(train_collater=ClassificationCollater()), packed.PackedLoader,
         np.float32),
        (dict(train_collater=ClassificationCollater(np.uint8)),
         packed.PackedLoader, np.uint8),
        (dict(train_collater=None, device_augment=lambda b, g: b),
         packed.PackedLoader, np.uint8),
        (dict(train_collater=packed_tasks.PackedDetectionCollate()),
         packed.PackedLoader, None),
        (dict(train_collater=MixupCutmixClassificationCollater(
            num_classes=3)), DataLoader, np.float32),
    ]
    for fields, kind, dtype in cases:
        loader = train_loader(_Config(train_dataset=pds, **fields), 4, 2, 0)
        assert type(loader) is kind, fields
        if kind is packed.PackedLoader and dtype is not None:
            assert first(loader)["image"].dtype == dtype
    tds = packed.PackedDataset(path, transform=lambda s: s)
    assert type(train_loader(_Config(
        train_dataset=tds, train_collater=ClassificationCollater()),
        4, 2, 0)) is DataLoader
    assert type(train_loader(_Config(
        train_dataset=FakeClassificationDataset(8, 8),
        train_collater=ClassificationCollater()), 4, 2, 0)) is DataLoader
    # the packed batch equals the JAX PackedLoader's with the same cast
    mine = first(train_loader(_Config(train_dataset=pds,
                                      train_collater=None), 4, 2, 0))
    theirs = next(iter(jax_packed.PackedLoader(
        path, 4, seed=0, collate=lambda b: {
            **b, "image": b["image"].astype(np.float32)})))
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_trainer_trains_an_epoch_from_a_pack(tmp_path):
    path = str(tmp_path / "c.pack")
    packed.pack_dataset(FakeClassificationDataset(16, 8, 4), path)
    cfg = _Config(model=TinyClassifier(4), train_dataset=packed.PackedDataset(
        path), train_collater=ClassificationCollater(),
        test_dataset=FakeClassificationDataset(8, 8, 4),
        test_collater=ClassificationCollater(), train_criterion=CELoss(),
        optimizer=("SGD", {"lr": 0.01, "momentum": 0.9,
                           "weight_decay": 0.0}),
        scheduler=("MultiStepLR", {"milestones": [5]}), epochs=1,
        print_interval=1, network="tiny")
    trainer = Trainer(cfg, str(tmp_path / "run"),
                      make_loss_fn=port_task.make_loss_fn,
                      make_eval_fn=port_task.make_eval_fn,
                      evaluate=port_task.evaluate, device="cpu")
    assert isinstance(trainer.train_loader, packed.PackedLoader)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.run()
    after = trainer.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert (tmp_path / "run/checkpoints/latest/1.pt").is_file()
