"""The port's folder readers (``simpleaicv_tpu_torch/data/datasets/
{ade20k,combined_folder,face_images,more_datasets}.py``) against the JAX
package's, sample by sample, on trees the test writes in each reader's
layout:

* ADE20K: ``images/<set>/*.jpg`` with ``annotations/<set>/*.png`` label
  maps, grey and palette PNGs, with and without ``reduce_zero_label``;
* the folder pairs of salient detection, matting, human and face parsing
  (``<root>/<set>/<type>/`` with ``.jpg`` or ``.jpeg`` images and
  same-stem ``.png`` masks: grey, palette, palette with ``tRNS``, RGB,
  RGBA, LA and 16-bit grey), across two sets, with unpaired files;
* WIDER FACE: ``images/<type>/`` and ``annotations/<set>_<type>.json``;
* CelebA-HQ and FFHQ image folders with ``DiffusionNormalize``;
* ACCV2022's folder per class.

Images, masks, trimaps, boxes, labels and sizes are equal: the JAX
readers decode with cv2 (``IMREAD_GRAYSCALE`` for the masks) and erode
and dilate with cv2, the port's decode with ``data/image_io.py`` and
morph with ``data/raster.py``. The reader modules import no cv2, jax,
flax, optax or the JAX package.
"""

import ast
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from simpleaicv_tpu.data.datasets import ade20k as jax_ade20k
from simpleaicv_tpu.data.datasets import combined_folder as jax_folder
from simpleaicv_tpu.data.datasets import face_images as jax_faces
from simpleaicv_tpu.data.datasets import more_datasets as jax_more
from simpleaicv_tpu_torch.data import datasets as port

from _torch_port import assert_samples_equal

PORT = Path(__file__).resolve().parent.parent / "simpleaicv_tpu_torch"
READER_MODULES = [
    "data/image_io.py", "data/raster.py", "data/datasets/__init__.py",
    "data/datasets/coco.py", "data/datasets/coco_instance.py",
    "data/datasets/coco_semantic.py", "data/datasets/sam_segmentation.py",
    "data/datasets/voc.py", "data/datasets/ade20k.py",
    "data/datasets/combined_folder.py", "data/datasets/text.py",
    "data/datasets/face_images.py", "data/datasets/more_datasets.py",
    "data/datasets/ilsvrc2012.py", "data/datasets/imagenet21k.py",
    "evaluation/text_eval.py", "tools/prepare_dataset.py",
    "tools/probe_configs.py", "demo/codec.py"]


def _image(rng, h, w):
    return cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8),
                            (5, 5), 1.5)


def _mask_png(path, rng, h, w, kind):
    """A mask PNG of ``kind``: values 0..255 in blobs, as each form."""
    yy, xx = np.mgrid[:h, :w]
    v = ((np.sin(xx / rng.uniform(3, 9)) + np.cos(yy / rng.uniform(3, 9))
          + 2) * 63.75).astype(np.uint8)
    v[rng.rand(h, w) < 0.3] = 255
    v[h // 4:3 * h // 4, w // 4:3 * w // 4] = 255
    v[:2] = 0
    rgb = np.dstack([v, 255 - v, v // 2])
    if kind == "grey":
        img = Image.fromarray(v)
    elif kind == "palette":
        img = Image.fromarray(rgb).quantize(16)
    elif kind == "palette_trns":
        img = Image.fromarray(rgb).quantize(16)
        img.info["transparency"] = 2
    elif kind == "rgb":
        img = Image.fromarray(rgb)
    elif kind == "rgba":
        img = Image.fromarray(np.dstack([rgb, v]))
    elif kind == "la":
        img = Image.fromarray(np.dstack([v, 255 - v]))
    else:  # 16-bit grey
        img = Image.fromarray(v.astype(np.uint16) * 257 + 3)
    img.save(path, **({"transparency": 2} if kind == "palette_trns"
                      else {}))


MASK_KINDS = ["grey", "palette", "palette_trns", "rgb", "rgba", "la",
              "grey16"]


def write_pairs(root, set_names, set_type="train", seed=0):
    rng = np.random.RandomState(seed)
    k = 0
    for s in set_names:
        d = os.path.join(root, s, set_type)
        os.makedirs(d, exist_ok=True)
        for i in range(len(MASK_KINDS)):
            h, w = (int(v) for v in rng.randint(30, 70, 2))
            ext = ".jpeg" if i == 2 else ".jpg"
            cv2.imwrite(os.path.join(d, f"p{i}{ext}"), _image(rng, h, w))
            _mask_png(os.path.join(d, f"p{i}.png"), rng, h, w,
                      MASK_KINDS[k % len(MASK_KINDS)])
            k += 1
        cv2.imwrite(os.path.join(d, "unpaired.jpg"), _image(rng, 9, 9))
        _mask_png(os.path.join(d, "lonely.png"), rng, 9, 9, "grey")


@pytest.fixture(scope="module")
def pairs_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pairs"))
    write_pairs(root, ["DIS5K", "HRSOD"])
    return root


def _tag(s):
    return {**s, "seen": True}


@pytest.mark.parametrize("cls", ["SalientObjectDetectionDataset",
                                 "HumanMattingDataset", "HumanParsingDataset",
                                 "FaceParsingDataset"])
def test_folder_pairs_match_jax(pairs_root, cls):
    kw = {"trimap_kernel": 7} if cls == "HumanMattingDataset" else {}
    sets = ["DIS5K", "HRSOD", "absent"]
    mine = getattr(port, cls)(pairs_root, sets, "train", transform=_tag,
                              **kw)
    theirs = getattr(jax_folder, cls)(pairs_root, sets, "train",
                                      transform=_tag, **kw)
    assert len(mine) == len(theirs) == 2 * len(MASK_KINDS)
    for i in range(len(theirs)):
        assert_samples_equal(mine[i], theirs[i], f"{cls} {i}")
    if cls == "HumanMattingDataset":
        trimaps = np.concatenate([mine[i]["trimap"].ravel()
                                  for i in range(len(mine))])
        assert set(np.unique(trimaps)) == {0.0, 128.0, 255.0}


@pytest.mark.parametrize("reduce_zero_label", [True, False])
def test_ade20k_matches_jax(tmp_path, reduce_zero_label):
    rng = np.random.RandomState(1)
    for split in ("training", "validation"):
        os.makedirs(tmp_path / "images" / split)
        os.makedirs(tmp_path / "annotations" / split)
        for i in range(4):
            h, w = (int(v) for v in rng.randint(30, 70, 2))
            name = f"ADE_{split}_{i:08d}"
            cv2.imwrite(str(tmp_path / "images" / split / f"{name}.jpg"),
                        _image(rng, h, w))
            if i == 3:
                continue  # an image without its label map
            labels = rng.randint(0, 151, (h, w)).astype(np.uint8)
            if i == 1:  # a palette label map
                img = Image.fromarray(labels, "L").convert("P")
            else:
                img = Image.fromarray(labels)
            img.save(tmp_path / "annotations" / split / f"{name}.png")
    for split in ("training", "validation"):
        mine = port.ADE20KDataset(str(tmp_path), split,
                                  reduce_zero_label=reduce_zero_label,
                                  transform=_tag)
        theirs = jax_ade20k.ADE20KDataset(
            str(tmp_path), split, reduce_zero_label=reduce_zero_label,
            transform=_tag)
        assert len(mine) == len(theirs) == 3
        for i in range(3):
            assert_samples_equal(mine[i], theirs[i], f"{split} {i}")


def test_face_detection_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    for s in ("wider_face", "other_faces"):
        os.makedirs(tmp_path / s / "images" / "val")
        os.makedirs(tmp_path / s / "annotations")
        labels = {}
        for i in range(4):
            h, w = (int(v) for v in rng.randint(30, 70, 2))
            name = f"{i}_face.jpg"
            cv2.imwrite(str(tmp_path / s / "images" / "val" / name),
                        _image(rng, h, w))
            if i == 2:
                continue  # an image the json does not name
            boxes = [[float(v) for v in np.sort(rng.uniform(0, 30, 4))]
                     for _ in range(i % 3)]
            labels[name] = {"face_box": boxes}
        with open(tmp_path / s / "annotations" / f"{s}_val.json", "w") as f:
            json.dump(labels, f)
    sets = ("wider_face", "other_faces")
    mine = port.FaceDetectionDataset(str(tmp_path), sets, "val",
                                     transform=_tag)
    theirs = jax_folder.FaceDetectionDataset(str(tmp_path), sets, "val",
                                             transform=_tag)
    assert len(mine) == len(theirs) == 6
    for i in range(6):
        assert_samples_equal(mine[i], theirs[i], str(i))


@pytest.mark.parametrize("cls,set_name", [("CelebAHQDataset", "train"),
                                          ("FFHQDataset", "training")])
def test_face_image_folders_match_jax(tmp_path, cls, set_name):
    rng = np.random.RandomState(3)
    d = tmp_path / set_name
    os.makedirs(d)
    for i, ext in enumerate((".jpg", ".PNG", ".jpeg", ".png")):
        cv2.imwrite(str(d / f"{i:05d}{ext}"), _image(rng, 32, 32))
    (d / "notes.txt").write_text("not an image")
    mine = getattr(port, cls)(str(tmp_path),
                              transform=port.face_images.DiffusionNormalize())
    theirs = getattr(jax_faces, cls)(str(tmp_path),
                                     transform=jax_faces.DiffusionNormalize())
    assert len(mine) == len(theirs) == 4
    for i in range(4):
        a, b = mine[i], theirs[i]
        assert_samples_equal(a, b, str(i))
        assert a["image"].min() >= -1 and a["image"].max() <= 1


def test_accv2022_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    for c in ("0003", "0001", "0010"):
        os.makedirs(tmp_path / "train" / c)
        for i in range(2):
            cv2.imwrite(str(tmp_path / "train" / c / f"{i}.jpg"),
                        _image(rng, 20 + i, 24))
    mine = port.ACCV2022Dataset(str(tmp_path), "train")
    theirs = jax_more.ACCV2022Dataset(str(tmp_path), "train")
    assert len(mine) == len(theirs) == 6
    for i in range(6):
        assert_samples_equal(mine[i], theirs[i], str(i))


def test_reader_modules_import_no_cv2_jax_or_the_jax_package():
    banned = ("cv2", "jax", "flax", "optax", "simpleaicv_tpu")
    for rel in READER_MODULES:
        for node in ast.walk(ast.parse((PORT / rel).read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (rel, name)


def test_every_jax_reader_has_its_counterpart():
    import simpleaicv_tpu.data.datasets as jax_datasets
    names = [n for n in dir(jax_datasets) if not n.startswith("_")
             and isinstance(getattr(jax_datasets, n), type)]
    assert len(names) == 29
    for name in names + ["evaluate_voc_detection"]:
        assert hasattr(port, name), name
