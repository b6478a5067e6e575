"""The port's CIFAR, ILSVRC2012 and ImageNet-21K readers and its libjpeg
binding (``simpleaicv_tpu_torch/data/datasets/{cifar,ilsvrc2012,
imagenet21k}.py``, ``data/native_io.py``) against the JAX package's and
OpenCV on the CPU:

* the CIFAR-10 and CIFAR-100 readers on pickles the test writes, sample
  for sample equal to the JAX readers;
* libjpeg's full-size decode against ``cv2.imdecode`` (the JAX readers'
  decode) on 4:2:0, 4:2:2 and 4:4:4 JPEGs of odd sizes at three
  qualities: within one level (read: equal on every pixel of this box's
  files; libjpeg and OpenCV's libjpeg-turbo may round an IDCT or a chroma
  upsample otherwise elsewhere);
* the DCT-scaled stretch resize (``native_decode_hw``) equal to the JAX
  package's native library where that library is built
  (``csrc/libsimpleaicv_io.so``), and, where no DCT scale applies, within
  1e-3 of OpenCV's decode and f32 ``cv2.resize`` (read: 1.9e-4);
* the ILSVRC2012 reader's class ids and images against the JAX reader's,
  and a PNG in the folder raising with its name (the JAX reader decodes it
  with cv2);
* the ImageNet-21K readers on a semantic tree written with ``torch.save``:
  the hierarchy levels, normalisation factors and semantic labels equal to
  the JAX reader's, and the collater's batch;
* the slice's modules import no cv2, jax, flax, optax or the JAX package.
"""

import ast
import os
import pickle
import warnings
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from simpleaicv_tpu.data import native_io as jax_native_io
from simpleaicv_tpu.data.datasets import cifar as jax_cifar
from simpleaicv_tpu.data.datasets import ilsvrc2012 as jax_ilsvrc
from simpleaicv_tpu.data.datasets import imagenet21k as jax_21k
from simpleaicv_tpu_torch.data import native_io
from simpleaicv_tpu_torch.data.datasets import (CIFAR10Dataset,
                                                CIFAR100Dataset,
                                                ILSVRC2012Dataset)
from simpleaicv_tpu_torch.data.datasets import imagenet21k

from _torch_port import one_torch_thread

PORT = Path(__file__).resolve().parent.parent / "simpleaicv_tpu_torch"
SLICE_MODULES = [
    "models/backbones/convformer.py", "models/backbones/van.py",
    "models/backbones/darknet.py", "models/backbones/resnetforcifar.py",
    "data/native_io.py", "data/host_build.py", "data/packed.py",
    "data/packed_tasks.py", "data/datasets/cifar.py",
    "data/datasets/ilsvrc2012.py", "data/datasets/imagenet21k.py",
    "tools/train_imagenet21k_classification.py",
    "tools/test_imagenet21k_classification.py",
    "tools/prepare_dataset.py"]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def test_slice_modules_import_no_cv2_jax_or_the_jax_package():
    banned = ("cv2", "jax", "flax", "optax", "simpleaicv_tpu")
    for rel in SLICE_MODULES:
        tree = ast.parse((PORT / rel).read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (rel, name)


def _write_cifar(root, kind):
    rng = np.random.RandomState(0)
    if kind == "cifar10":
        sub, files, key = "cifar-10-batches-py", [f"data_batch_{i}" for i in
                                                  range(1, 6)] + [
            "test_batch"], b"labels"
    else:
        sub, files, key = "cifar-100-python", ["train", "test"], b"fine_labels"
    os.makedirs(root / sub)
    for i, name in enumerate(files):
        n = 3 + i
        entry = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                 key: rng.randint(0, 100, n).tolist()}
        with open(root / sub / name, "wb") as f:
            pickle.dump(entry, f)


@pytest.mark.parametrize("kind", ["cifar10", "cifar100"])
def test_cifar_readers_match_jax(tmp_path, kind):
    _write_cifar(tmp_path, kind)
    mine_cls = CIFAR10Dataset if kind == "cifar10" else CIFAR100Dataset
    theirs_cls = (jax_cifar.CIFAR10Dataset if kind == "cifar10"
                  else jax_cifar.CIFAR100Dataset)
    for split in ("train", "test"):
        mine = mine_cls(str(tmp_path), split, transform=lambda s: {
            **s, "seen": True})
        theirs = theirs_cls(str(tmp_path), split)
        assert len(mine) == len(theirs) > 0
        for i in range(len(theirs)):
            a, b = mine[i], theirs[i]
            assert a["seen"] and a["label"] == b["label"]
            assert a["image"].dtype == np.float32
            assert a["image"].shape == (32, 32, 3)
            np.testing.assert_array_equal(a["image"], b["image"])


def _jpegs():
    """(name, JPEG bytes) at odd sizes, three chroma samplings and three
    qualities, from blurred noise."""
    rng = np.random.RandomState(1)
    out = []
    for h, w in ((37, 53), (64, 48), (101, 77)):
        img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8),
                               (7, 7), 2)
        for sampling in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444):
            for quality in (50, 90, 100):
                ok, buf = cv2.imencode(".jpg", img, [
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
                assert ok
                out.append((f"{h}x{w}_s{sampling}_q{quality}", buf.tobytes()))
    return out


def _cv2_rgb(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[:, :, ::-1]


def decode_disagreement():
    """The largest level difference of the full decode from OpenCV's over
    ``_jpegs()``, and the share of pixels that differ."""
    worst, differ, total = 0, 0, 0
    for _, data in _jpegs():
        got = native_io.decode_image(data).astype(int)
        want = _cv2_rgb(data).astype(int)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        worst = max(worst, int(diff.max()))
        differ += int((diff > 0).sum())
        total += diff.size
    return worst, differ / total


def test_full_decode_matches_opencv():
    worst, share = decode_disagreement()
    assert worst <= 1, (worst, share)


def test_resized_decode_matches_the_jax_library_and_opencv():
    jax_lib = jax_native_io.available()
    worst = 0.0
    for name, data in _jpegs():
        for hw, letterbox in ((32, False), ((24, 40), True), (80, False)):
            got = native_io.decode_resize(data, hw, letterbox=letterbox)
            if jax_lib:
                np.testing.assert_array_equal(
                    got, jax_native_io.decode_resize(data, hw,
                                                     letterbox=letterbox))
            if not letterbox:
                h = w = hw
                img = _cv2_rgb(data)
                if img.shape[0] >= 2 * h or img.shape[1] >= 2 * w:
                    continue  # libjpeg decodes at a DCT scale there
                want = cv2.resize(img.astype(np.float32), (w, h))
                worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= 1e-3, worst
    with pytest.raises(ValueError, match="not a decodable JPEG"):
        native_io.decode_resize(b"\x89PNG not a jpeg", 8)


def _image_tree(root, classes, per_class=2, seed=0, png=False):
    """``root/<class>/<i>.jpg`` from blurred noise of varying sizes."""
    rng = np.random.RandomState(seed)
    for c in classes:
        os.makedirs(root / c, exist_ok=True)
        for i in range(per_class):
            h, w = rng.randint(20, 60, 2)
            img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(
                np.uint8), (5, 5), 1.5)
            cv2.imwrite(str(root / c / f"{i}.jpg"), img)
    if png:
        cv2.imwrite(str(root / classes[0] / "z.png"),
                    np.zeros((8, 8, 3), np.uint8))


def test_ilsvrc2012_reader_matches_jax(tmp_path):
    _image_tree(tmp_path / "train", ["n02", "n01", "n10"])
    mine = ILSVRC2012Dataset(str(tmp_path), "train")
    theirs = jax_ilsvrc.ILSVRC2012Dataset(str(tmp_path), "train")
    assert len(mine) == len(theirs) == 6
    for i in range(6):
        a, b = mine[i], theirs[i]
        assert a["label"] == b["label"] == i // 2
        assert a["image"].dtype == np.float32
        assert np.abs(a["image"] - b["image"]).max() <= 1
    sized = ILSVRC2012Dataset(str(tmp_path), "train", native_decode_hw=24)
    assert len(sized) == 6
    with open(sized._items[3][0], "rb") as f:
        np.testing.assert_array_equal(
            sized[3]["image"], native_io.decode_resize(f.read(), 24,
                                                       letterbox=False))
    _image_tree(tmp_path / "val", ["n01"], png=True)
    reader = ILSVRC2012Dataset(str(tmp_path), "val")
    with pytest.raises(ValueError, match="z.png"):
        reader[2]


def _tree_file(path):
    """A small semantic tree: each class's chain from itself up to its
    root, as the miil tree's ``class_tree_list`` holds it."""
    class_tree_list = [[0], [1], [2, 0], [3, 0], [4, 1], [5, 2, 0],
                       [6, 2, 0], [7, 3, 0], [8, 4, 1], [9]]
    torch.save({"class_tree_list": class_tree_list}, str(path))
    return len(class_tree_list)


def test_imagenet21k_readers_match_jax(tmp_path):
    n = _tree_file(tmp_path / "imagenet21k_miil_tree.pth")
    _image_tree(tmp_path / "train", [f"c{i:02d}" for i in range(n)],
                per_class=1, seed=3)
    mine = imagenet21k.ImageNet21KSemanticTreeLabelDataset(str(tmp_path))
    theirs = jax_21k.ImageNet21KSemanticTreeLabelDataset(str(tmp_path))
    mine._load_tree()
    theirs._load_tree()
    assert len(mine.hierarchy_indices_list) == len(
        theirs.hierarchy_indices_list) == 3
    for a, b in zip(mine.hierarchy_indices_list,
                    theirs.hierarchy_indices_list):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.normalization_factor_list,
                                  theirs.normalization_factor_list)
    labels = np.arange(n)
    np.testing.assert_array_equal(
        mine.convert_single_labels_to_semantic_labels(labels),
        theirs.convert_single_labels_to_semantic_labels(labels))
    samples = [mine[i] for i in (0, 5, 8)]
    want = [theirs[i] for i in (0, 5, 8)]
    for a, b in zip(samples, want):
        assert a["label"] == b["label"]
        assert np.abs(a["image"] - b["image"]).max() <= 1
    crop = lambda s: {**s, "image": s["image"][:16, :16]}  # noqa: E731
    got = imagenet21k.ImageNet21KSemanticCollater(mine)(
        [crop(s) for s in samples])
    exp = jax_21k.ImageNet21KSemanticCollater(theirs)(
        [crop(s) for s in samples])
    assert got.keys() == exp.keys()
    for k in ("label", "semantic_label"):
        assert got[k].dtype == exp[k].dtype
        np.testing.assert_array_equal(got[k], exp[k])
    single = imagenet21k.ImageNet21KSingleLabelDataset(str(tmp_path))
    assert [single[i]["label"] for i in range(n)] == list(range(n))


def test_batch_decode_pad_fills_a_failed_file(tmp_path):
    """The uint8 batch decode (the pack writer's) on a thread pool: each
    slot ``decode_resize`` rounded (half away from zero), the missing
    file's slot ``pad_value``, a warning with the count."""
    _image_tree(tmp_path, ["a"], per_class=2)
    paths = [str(tmp_path / "a/0.jpg"), str(tmp_path / "missing.jpg"),
             str(tmp_path / "a/1.jpg")]
    for hw, letterbox in ((16, True), ((12, 20), False)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, ok = native_io.batch_decode_files_u8(
                paths, hw, n_threads=2, pad_value=7, letterbox=letterbox,
                return_ok=True)
        assert ok == 2 and any("1/3 files failed" in str(w.message)
                               for w in caught)
        assert (out[1] == 7).all()
        for j in (0, 2):
            with open(paths[j], "rb") as f:
                want = native_io.decode_resize(f.read(), hw, pad_value=7,
                                               letterbox=letterbox)
            np.testing.assert_array_equal(out[j], np.clip(np.floor(
                want + 0.5), 0, 255))
