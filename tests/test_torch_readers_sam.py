"""The port's SA-1B reader (``simpleaicv_tpu_torch/data/datasets/
sam_segmentation.py``) against the JAX package's, sample by sample, on an
SA-1B tree the test writes: ``<root>/<set>/<set_type>/`` JPEGs and PNGs
with same-stem jsons whose masks are compressed RLE (as real SA-1B writes
them), uncompressed RLE, RLE without a size and polygons (some across the
image's border), an image with no annotation, an image without a json
and a set without the ``<set_type>`` folder. Images and masks are equal:
the JAX reader decodes with cv2 and fills with ``cv2.fillPoly``. Its
random mask comes from the global ``random``, the port's from the
``random.Random`` it is given: seeded alike, they choose alike. The
``pack-sam`` subcommand packs what the port's reader reads.
"""

import json
import os
import random

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data.datasets import sam_segmentation as jax_sam
from simpleaicv_tpu_torch.data.datasets import SAMSegmentationDataset
from simpleaicv_tpu_torch.data.packed import PackReader
from simpleaicv_tpu_torch.data.rle import mask_to_rle_counts, rle_encode
from simpleaicv_tpu_torch.tools import prepare_dataset

from _torch_port import assert_samples_equal


def _ellipse(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.randint(0, h), rng.randint(0, w)
    return ((yy - cy) ** 2 / rng.uniform(9, 300)
            + (xx - cx) ** 2 / rng.uniform(9, 300) < 1).astype(np.uint8)


def _segmentation(rng, kind, h, w):
    if kind == 0:
        return rle_encode(_ellipse(rng, h, w))
    if kind == 1:
        return {"counts": mask_to_rle_counts(_ellipse(rng, h, w)),
                "size": [h, w]}
    if kind == 2:
        return {"counts": rle_encode(_ellipse(rng, h, w))["counts"]}
    pts = np.stack([rng.uniform(-0.2, 1.2, 6) * w,
                    rng.uniform(-0.2, 1.2, 6) * h], 1)
    return [[float(v) for v in pts.reshape(-1)]]


def write_sa1b(root, set_name, set_type="train", n=5, seed=0,
               nested=True):
    """``root/<set_name>[/<set_type>]/sa_<i>.{jpg,png}`` and jsons."""
    rng = np.random.RandomState(seed)
    d = os.path.join(root, set_name, set_type) if nested else \
        os.path.join(root, set_name)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        h, w = (int(v) for v in rng.randint(30, 80, 2))
        img = cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8),
                               (5, 5), 1.5)
        ext = ".png" if i == 1 else ".jpg"
        cv2.imwrite(os.path.join(d, f"sa_{i}{ext}"), img)
        if i == n - 1:
            continue  # an image without a json
        annots = [] if i == 2 else [
            {"id": k, "segmentation": _segmentation(rng, (i + k) % 4, h, w),
             "area": float(rng.randint(1, 500)), "bbox": [0, 0, 1, 1]}
            for k in range(rng.randint(2, 6))]
        with open(os.path.join(d, f"sa_{i}.json"), "w") as f:
            json.dump({"image": {"height": h, "width": w},
                       "annotations": annots}, f)


@pytest.fixture(scope="module")
def sa1b_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sa1b"))
    write_sa1b(root, "sa_000020")
    write_sa1b(root, "sa_000021", n=4, seed=1, nested=False)
    return root


SETS = ["sa_000020", "sa_000021", "sa_absent"]


@pytest.mark.parametrize("seed", [0, 5])
def test_random_mask_matches_jax(sa1b_root, seed):
    mine = SAMSegmentationDataset(sa1b_root, SETS, "train",
                                  rng=random.Random(seed),
                                  transform=lambda s: {**s, "seen": True})
    theirs = jax_sam.SAMSegmentationDataset(
        sa1b_root, SETS, "train", transform=lambda s: {**s, "seen": True})
    assert len(mine) == len(theirs) == 7
    random.seed(seed)
    for epoch in range(3):
        for i in range(len(theirs)):
            assert_samples_equal(mine[i], theirs[i], f"{epoch} {i}")


def test_biggest_mask_matches_jax(sa1b_root):
    mine = SAMSegmentationDataset(sa1b_root, SETS, "train",
                                  per_image_mask_chosen="biggest")
    theirs = jax_sam.SAMSegmentationDataset(sa1b_root, SETS, "train",
                                            per_image_mask_chosen="biggest")
    assert len(mine) == len(theirs)
    for i in range(len(theirs)):
        a, b = mine[i], theirs[i]
        assert_samples_equal(a, b, str(i))
    assert sum(int(mine[i]["mask"].any()) for i in range(len(mine))) >= 4


def test_every_annotation_decodes_as_jax(sa1b_root):
    """Each json's every mask, not only the chosen one."""
    ds = SAMSegmentationDataset(sa1b_root, SETS, "train")
    ds._scan()
    from simpleaicv_tpu_torch.data.datasets.coco_instance import \
        segmentation_to_mask
    n = 0
    for img_path, json_path in ds._items:
        h, w = cv2.imread(img_path).shape[:2]
        with open(json_path) as f:
            for a in json.load(f)["annotations"]:
                want = jax_sam._decode_segmentation(a["segmentation"], h, w)
                got = segmentation_to_mask(a["segmentation"], h, w)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
                n += 1
    assert n >= 15


def test_pack_sam_packs_the_readers_masks(sa1b_root, tmp_path):
    out = str(tmp_path / "s.pack")
    assert prepare_dataset.main([
        "pack-sam", "--root", sa1b_root, "--out", out, "--set-names",
        "sa_000020", "sa_000021", "--set-type", "train", "--size", "64",
        "--point-candidates", "8"]) == 0
    pack = PackReader(out)
    ds = SAMSegmentationDataset(sa1b_root, ["sa_000020", "sa_000021"],
                                "train")
    assert len(pack) == len(ds) == 7
    for i in range(len(ds)):
        rec = pack.read_sample(i)
        mask = np.unpackbits(rec["mask_bits"], axis=1)
        ys, xs = np.nonzero(mask)
        if len(ys):
            np.testing.assert_array_equal(
                rec["box"], [xs.min(), ys.min(), xs.max(), ys.max()])
        else:
            assert not rec["box"].any()
