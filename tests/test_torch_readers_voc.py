"""The port's VOC reader and VOC AP (``simpleaicv_tpu_torch/data/
datasets/voc.py``) and its WIDER FACE AP (``evaluation/text_eval.py::
evaluate_widerface_style``) against the JAX package's:

* ``VocDetection`` sample by sample on a VOC2007 + VOC2012 tree the test
  writes (xml with difficult objects, padded class names, an image with
  no kept object), with and without ``keep_difficult``: images, boxes,
  labels and sizes equal;
* ``compute_voc_ap`` in both forms and ``evaluate_voc_detection`` on
  drawn detections (ties of score, images without detections or ground
  truth, classes without ground truth), equal to the last bit;
* ``evaluate_widerface_style`` over three subsets, equal.
"""

import os
import xml.etree.ElementTree as ET

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data.datasets import voc as jax_voc
from simpleaicv_tpu.evaluation import text_eval as jax_text_eval
from simpleaicv_tpu_torch.data.datasets import voc
from simpleaicv_tpu_torch.evaluation.text_eval import \
    evaluate_widerface_style

from _torch_port import assert_samples_equal


def write_voc(root, year, ids, seed):
    rng = np.random.RandomState(seed)
    base = os.path.join(root, f"VOC{year}")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("".join(f"{i}\n" for i in ids))
    for k, name in enumerate(ids):
        h, w = rng.randint(30, 70, 2)
        cv2.imwrite(os.path.join(base, "JPEGImages", f"{name}.jpg"),
                    cv2.GaussianBlur((rng.rand(h, w, 3) * 255).astype(
                        np.uint8), (5, 5), 1.5))
        ann = ET.Element("annotation")
        for j in range(0 if k == 1 else rng.randint(1, 5)):
            obj = ET.SubElement(ann, "object")
            cls = voc.VOC_CLASSES[rng.randint(20)]
            ET.SubElement(obj, "name").text = (
                f" {cls.upper()} " if j == 0 else cls)
            ET.SubElement(obj, "difficult").text = str(int(j == 1))
            box = ET.SubElement(obj, "bndbox")
            x1, y1 = rng.randint(1, w // 2), rng.randint(1, h // 2)
            for tag, v in (("xmin", x1), ("ymin", y1),
                           ("xmax", x1 + rng.randint(2, w // 2)),
                           ("ymax", y1 + rng.randint(2, h // 2))):
                ET.SubElement(box, tag).text = str(v)
        ET.ElementTree(ann).write(os.path.join(base, "Annotations",
                                               f"{name}.xml"))


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_voc_detection_matches_jax(tmp_path, keep_difficult):
    write_voc(str(tmp_path), "2007", ["000005", "000007", "000009"], 0)
    write_voc(str(tmp_path), "2012", ["2008_000002", "2008_000003"], 1)
    sets = (("2007", "trainval"), ("2012", "trainval"))
    tag = lambda s: {**s, "seen": True}  # noqa: E731
    mine = voc.VocDetection(str(tmp_path), sets, transform=tag,
                            keep_difficult=keep_difficult)
    theirs = jax_voc.VocDetection(str(tmp_path), sets, transform=tag,
                                  keep_difficult=keep_difficult)
    assert len(mine) == len(theirs) == 5
    n = 0
    for i in range(5):
        assert_samples_equal(mine[i], theirs[i], str(i))
        n += len(mine[i]["annots"])
    assert n >= 3


def _results(rng, n_images, num_classes):
    out = []
    for i in range(n_images):
        n_gt = 0 if i == 0 else rng.randint(1, 5)
        gt = rng.uniform(0, 50, (n_gt, 2))
        gt_boxes = np.concatenate([gt, gt + rng.uniform(5, 30, (n_gt, 2))],
                                  1)
        n_det = 0 if i == 1 else rng.randint(1, 8)
        pick = rng.randint(0, max(n_gt, 1), n_det)
        jitter = rng.normal(0, 4, (n_det, 4))
        det = (gt_boxes[pick] if n_gt else rng.uniform(0, 60, (n_det, 4)))
        out.append({
            "det_boxes": (det + jitter).astype(np.float32),
            "det_scores": np.round(rng.uniform(0, 1, n_det), 1).astype(
                np.float32),
            "det_classes": rng.randint(0, num_classes, n_det),
            "gt_boxes": gt_boxes.astype(np.float32),
            "gt_classes": rng.randint(0, max(num_classes - 1, 1), n_gt)})
    return out


@pytest.mark.parametrize("use_07_metric", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_ap_matches_jax(seed, use_07_metric):
    rng = np.random.RandomState(seed)
    results = _results(rng, 12, 4)
    got = voc.evaluate_voc_detection(results, 4, use_07_metric=use_07_metric)
    want = jax_voc.evaluate_voc_detection(results, 4,
                                          use_07_metric=use_07_metric)
    assert got == want
    assert set(got["per_class_ap"]) == {0, 1, 2}
    recall = np.sort(rng.uniform(0, 1, 20))
    precision = rng.uniform(0, 1, 20)
    assert voc.compute_voc_ap(recall, precision, use_07_metric) == \
        jax_voc.compute_voc_ap(recall, precision, use_07_metric)


def test_widerface_style_matches_jax():
    rng = np.random.RandomState(3)
    subsets = {k: _results(rng, 8, 1) for k in ("easy", "medium", "hard")}
    got = evaluate_widerface_style(subsets)
    assert got == jax_text_eval.evaluate_widerface_style(subsets)
    assert set(got) == {"easy_ap", "medium_ap", "hard_ap", "key_metric"}
    assert 0 < got["key_metric"] < 1
