"""The port's COCO-layout readers (``simpleaicv_tpu_torch/data/datasets/
{coco,coco_instance,coco_semantic,more_datasets}.py``) against the JAX
package's, sample by sample, on a COCO tree the test writes: an
``instances_<set>.json`` with categories of sparse ids, polygons (several
to an object), uncompressed and compressed RLE, a crowd annotation, boxes
with a side under 1 and with no area, an annotation marked ``ignore``, an
image with no object, and JPEGs under ``images/<set>/`` and ``<set>/``.
Images, boxes, labels, masks and sizes are equal: the JAX readers decode
with cv2 and rasterise with ``cv2.fillPoly``, the port's with PIL
(``data/image_io.py``) and ``data/raster.py``. The ``pack-coco``
subcommand packs what the port's reader reads.
"""

import json
import os

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data.datasets import coco as jax_coco
from simpleaicv_tpu.data.datasets import coco_instance as jax_instance
from simpleaicv_tpu.data.datasets import coco_semantic as jax_semantic
from simpleaicv_tpu.data.datasets import more_datasets as jax_more
from simpleaicv_tpu_torch.data import datasets as port
from simpleaicv_tpu_torch.data.packed import PackReader
from simpleaicv_tpu_torch.data.rle import mask_to_rle_counts, rle_encode
from simpleaicv_tpu_torch.tools import prepare_dataset

from _torch_port import assert_samples_equal

CATEGORY_IDS = [90, 1, 7, 3, 44]


def _polygon(rng, h, w):
    """A random star-shaped polygon with float vertices."""
    cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
    n = rng.randint(3, 9)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(3, min(h, w) / 2.5, n)
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
    return [float(v) for v in pts.reshape(-1)]


def _blob(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.randint(0, h), rng.randint(0, w)
    return ((yy - cy) ** 2 / rng.uniform(9, 200)
            + (xx - cx) ** 2 / rng.uniform(9, 200) < 1).astype(np.uint8)


def write_coco(root, set_name, n_images=6, seed=0):
    """A COCO tree under ``root``; every kind of annotation the readers
    meet."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n_images):
        h, w = rng.randint(40, 90, 2)
        img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8),
                               (5, 5), 1.5)
        sub = ("images", set_name) if i % 2 == 0 else (set_name,)
        os.makedirs(os.path.join(root, *sub), exist_ok=True)
        name = f"{i:012d}.jpg"
        cv2.imwrite(os.path.join(root, *sub, name), img)
        image_id = 1000 + 7 * i
        images.append({"id": image_id, "file_name": name, "height": int(h),
                       "width": int(w)})
        if i == n_images - 1:
            continue  # an image with no object
        for k in range(rng.randint(2, 6)):
            kind = (i + k) % 5
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = rng.uniform(1, w / 2), rng.uniform(1, h / 2)
            a = {"id": len(anns) + 1, "image_id": image_id,
                 "category_id": CATEGORY_IDS[rng.randint(5)],
                 "bbox": [x, y, bw, bh], "area": float(bw * bh),
                 "iscrowd": 0}
            if kind in (0, 1):
                a["segmentation"] = [_polygon(rng, h, w)
                                     for _ in range(kind + 1)]
            elif kind == 2:
                a["segmentation"] = {"counts": mask_to_rle_counts(
                    _blob(rng, h, w)), "size": [int(h), int(w)]}
            elif kind == 3:
                a["segmentation"] = rle_encode(_blob(rng, h, w))
            else:
                rle = rle_encode(_blob(rng, h, w))
                a["segmentation"] = {"counts": rle["counts"]}  # no size
            anns.append(a)
        # a crowd, a box under 1 wide, a box with no area, an ignored one
        extra = [dict(iscrowd=1, segmentation=rle_encode(_blob(rng, h, w))),
                 dict(bbox=[2.0, 3.0, 0.5, 9.0]),
                 dict(area=0.0),
                 dict(ignore=1)]
        e = extra[i % 4]
        a = {"id": len(anns) + 1, "image_id": image_id, "category_id": 3,
             "bbox": [1.0, 2.0, 10.0, 12.0], "area": 120.0, "iscrowd": 0,
             "segmentation": [_polygon(rng, h, w)]}
        a.update(e)
        anns.append(a)
    cats = [{"id": c, "name": f"class{c}"} for c in CATEGORY_IDS]
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    with open(os.path.join(root, "annotations",
                           f"instances_{set_name}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    write_coco(root, "train2017")
    write_coco(root, "val2017", n_images=4, seed=1)
    return root


def _tag(s):
    return {**s, "seen": True}


@pytest.mark.parametrize("filter_no_object_image", [False, True])
@pytest.mark.parametrize("cls", ["CocoDetection", "Objects365Detection",
                                 "SamaCocoDetection"])
def test_coco_detection_matches_jax(coco_root, cls, filter_no_object_image):
    jax_cls = getattr(jax_more if cls != "CocoDetection" else jax_coco, cls)
    for set_name in ("train2017", "val2017"):
        mine = getattr(port, cls)(coco_root, set_name, transform=_tag,
                                  filter_no_object_image=
                                  filter_no_object_image)
        theirs = jax_cls(coco_root, set_name, transform=_tag,
                         filter_no_object_image=filter_no_object_image)
        assert len(mine) == len(theirs) > 0
        assert mine.label_to_cat_id == theirs.label_to_cat_id
        assert mine.cat_id_to_label == theirs.cat_id_to_label
        assert mine.class_names == theirs.class_names
        for i in range(len(theirs)):
            assert_samples_equal(mine[i], theirs[i], f"{set_name} {i}")


def test_coco_detection_drops_crowd_and_degenerate_boxes(coco_root):
    ds = port.CocoDetection(coco_root, "train2017")
    kept = sum(len(ds[i]["annots"]) for i in range(len(ds)))
    with open(os.path.join(coco_root, "annotations",
                           "instances_train2017.json")) as f:
        anns = json.load(f)["annotations"]
    crowd = [a for a in anns if a["iscrowd"]]
    degenerate = [a for a in anns if a["bbox"][2] < 1 or a["area"] <= 0]
    assert len(crowd) == 2 and len(degenerate) == 2
    assert kept == len(anns) - 4
    assert len(port.CocoDetection(coco_root, "train2017",
                                  filter_no_object_image=True)) == 5


def test_coco_instance_segmentation_matches_jax(coco_root):
    for set_name in ("train2017", "val2017"):
        mine = port.CocoInstanceSegmentation(coco_root, set_name)
        theirs = jax_instance.CocoInstanceSegmentation(coco_root, set_name)
        assert len(mine) == len(theirs)
        n_masks = 0
        for i in range(len(theirs)):
            a, b = mine[i], theirs[i]
            assert_samples_equal(a, b, f"{set_name} {i}")
            n_masks += sum(int(m.any()) for m in a["masks"])
        assert n_masks > 5


@pytest.mark.parametrize("reduce_zero_label", [False, True])
def test_coco_semantic_segmentation_matches_jax(coco_root,
                                                reduce_zero_label):
    mine = port.CocoSemanticSegmentation(
        coco_root, "train2017", reduce_zero_label=reduce_zero_label)
    theirs = jax_semantic.CocoSemanticSegmentation(
        coco_root, "train2017", reduce_zero_label=reduce_zero_label)
    assert len(mine) == len(theirs)
    for i in range(len(theirs)):
        a, b = mine[i], theirs[i]
        assert_samples_equal(a, b, str(i))
    assert len(np.unique(mine[0]["mask"])) > 1


def test_pack_coco_packs_the_readers_samples(coco_root, tmp_path):
    out = str(tmp_path / "c.pack")
    assert prepare_dataset.main(["pack-coco", "--root", coco_root, "--out",
                                 out, "--set-name", "train2017", "--size",
                                 "64", "--max-annots", "8"]) == 0
    pack = PackReader(out)
    ds = port.CocoDetection(coco_root, "train2017",
                            filter_no_object_image=True)
    assert len(pack) == len(ds) == 5
    for i in range(len(ds)):
        rec, s = pack.read_sample(i), ds[i]
        factor = 64 / max(s["image"].shape[:2])
        n = len(s["annots"])
        np.testing.assert_array_equal(rec["annots"][:n, :4],
                                      s["annots"][:, :4] * np.float32(factor))
        np.testing.assert_array_equal(rec["annots"][:n, 4],
                                      s["annots"][:, 4])
        assert (rec["annots"][n:] == -1).all()
