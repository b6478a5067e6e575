"""The port's OCR readers (``simpleaicv_tpu_torch/data/datasets/
text.py``) against the JAX package's, sample by sample, on trees the test
writes: ``<root>/<set>/<type>/`` image folders with
``<set>_<type>.json`` label files over two sets (one without its label
file), keys whose image is missing, and every label form the readers
take: detection shapes under "shapes" or as a bare list, with "points" or
"box", "###" and "*" labels, an "ignore" flag and a polygon of two
points; recognition texts as strings and as {"label": text}. Images,
polygons, ignore flags and texts are equal.
"""

import json
import os

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data.datasets import text as jax_text
from simpleaicv_tpu_torch.data.datasets import TextDetection, TextRecognition

from _torch_port import assert_samples_equal

SETS = ["ICDAR2017RCTW_text_detection", "LSVT_text_detection", "absent"]


def _image(rng, h, w):
    return cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(np.uint8),
                            (5, 5), 1.5)


def _shape(rng, k):
    pts = np.round(rng.uniform(0, 60, (4 if k % 2 else 6, 2)), 1).tolist()
    shape = {"points" if k % 3 else "box": pts,
             "label": ["text", "###", "*", "abc"][k % 4]}
    if k % 5 == 1:
        shape["ignore"] = True
    if k % 7 == 6:
        shape["points"] = pts[:2]  # too few points
    return shape


def write_ocr(root, kind, seed=0):
    rng = np.random.RandomState(seed)
    for s_i, s in enumerate(SETS[:2] + ["no_labels"]):
        d = os.path.join(root, s, "train")
        os.makedirs(d)
        labels = {}
        for i in range(4):
            name = f"img_{i}.jpg"
            h, w = (int(v) for v in rng.randint(20, 60, 2))
            if i != 3:  # a key whose image is missing
                cv2.imwrite(os.path.join(d, name), _image(rng, h, w))
            if kind == "det":
                shapes = [_shape(rng, i + k) for k in range(rng.randint(1,
                                                                        6))]
                labels[name] = shapes if (i + s_i) % 2 else {
                    "shapes": shapes}
            else:
                text = "".join(rng.choice(list("0123456789abc"),
                                          rng.randint(1, 8)))
                labels[name] = {"label": text} if i % 2 else text
        if s != "no_labels":
            with open(os.path.join(root, s, f"{s}_train.json"), "w",
                      encoding="utf-8") as f:
                json.dump(labels, f)


@pytest.mark.parametrize("kind", ["det", "rec"])
def test_ocr_readers_match_jax(tmp_path, kind):
    write_ocr(str(tmp_path), kind, seed=1 if kind == "det" else 2)
    sets = SETS + ["no_labels"]
    cls, jax_cls = ((TextDetection, jax_text.TextDetection) if kind == "det"
                    else (TextRecognition, jax_text.TextRecognition))
    tag = lambda s: {**s, "seen": True}  # noqa: E731
    mine = cls(str(tmp_path), sets, "train", transform=tag)
    theirs = jax_cls(str(tmp_path), sets, "train", transform=tag)
    assert len(mine) == len(theirs) == 6
    for i in range(6):
        assert_samples_equal(mine[i], theirs[i], str(i))
    if kind == "det":
        flags = [f for i in range(6) for f in mine[i]["ignore_flags"]]
        assert True in flags and False in flags
