"""Raw OCR-detection downloads -> standardized detection sets (counterpart
of ``simpleaicv_tpu/data/processing/text_detection.py``), without OpenCV.

Each processor walks the raw layout of its source, normalizes transcripts
(``common.normalize_text``), funnels every image through the shared
validity pipeline (``common.validate_and_standardize``: max-side-1920
resize, border clip, self-intersection / min-area / DB-shrink-disjointness
checks) and writes the standard layout that
``data/datasets/text.py::TextDetection`` reads:

    <out_dir>/{train,test}/<SetName>_<stem>.jpg
    <out_dir>/<SetName>_{train,test}.json   # {name: [{points,label,ignore}]}

Raw layouts (the official downloads'):
  RCTW  root/train_images/*.jpg + root/train_gts/<stem>.txt
        (utf-8-sig lines: x1,y1,...,y4,<difficult>,"transcript")
  ART   root/train_images/*.jpg + root/train_labels.json
        ({stem: [{'points': [[x,y]..], 'transcription': str}]})
  LSVT  root/train_full_images/*.jpg + root/train_full_labels.json
        (same record shape as ART)
  MLT   root/train_images/*.jpg + root/train_gts/<stem>.txt
        (lines: x1..y4,language,transcript; Chinese/Latin images only)
  ReCTS root/img/*.jpg + root/gt/<stem>.json ({'chars': [{'points':
        [x1..y4], 'transcription': str}]})
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .common import (imread_any, normalize_text, validate_and_standardize,
                     write_standard_set)

RawSample = Tuple[str, str, List[Tuple[list, str]]]  # (stem, img_path, boxes)


def _quad(coords8) -> list:
    c = [float(v) for v in coords8]
    return [[c[0], c[1]], [c[2], c[3]], [c[4], c[5]], [c[6], c[7]]]


def iter_rctw(root: str) -> Iterator[RawSample]:
    img_dir = os.path.join(root, "train_images")
    gt_dir = os.path.join(root, "train_gts")
    for name in sorted(os.listdir(img_dir)):
        stem = name.split(".")[0]
        gt = os.path.join(gt_dir, stem + ".txt")
        if not os.path.exists(gt):
            continue
        if name == "image_6089.jpg":  # known-corrupt annotation upstream
            continue
        boxes = []
        with open(gt, encoding="utf-8-sig") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split(",")
                coords = [int(float(v)) for v in parts[:8]]
                # field 8 is the difficult flag; transcript from field 9 on,
                # quoted — strip the outer quotes after rejoining commas
                text = ",".join(parts[9:])[1:-1]
                boxes.append((_quad(coords), normalize_text(text)))
        yield stem, os.path.join(img_dir, name), boxes


def _iter_json_labelled(img_dir: str, labels: dict) -> Iterator[RawSample]:
    for name in sorted(os.listdir(img_dir)):
        stem = name.split(".")[0]
        records = labels.get(stem)
        if records is None:
            continue
        boxes = []
        ok = True
        for rec in records:
            pts = rec["points"]
            if len(pts) < 4:
                ok = False
                break
            text = normalize_text(rec.get("transcription", ""))
            if rec.get("illegibility", False):
                text = normalize_text("###")
            boxes.append(([[float(x), float(y)] for x, y in pts], text))
        if ok:
            yield stem, os.path.join(img_dir, name), boxes


def iter_art(root: str) -> Iterator[RawSample]:
    with open(os.path.join(root, "train_labels.json"),
              encoding="utf-8") as f:
        labels = json.load(f)
    yield from _iter_json_labelled(os.path.join(root, "train_images"), labels)


def iter_lsvt(root: str) -> Iterator[RawSample]:
    with open(os.path.join(root, "train_full_labels.json"),
              encoding="utf-8") as f:
        labels = json.load(f)
    yield from _iter_json_labelled(os.path.join(root, "train_full_images"),
                                   labels)


def iter_mlt(root: str) -> Iterator[RawSample]:
    img_dir = os.path.join(root, "train_images")
    gt_dir = os.path.join(root, "train_gts")
    for name in sorted(os.listdir(img_dir)):
        stem = name.split(".")[0]
        gt = os.path.join(gt_dir, stem + ".txt")
        if not os.path.exists(gt):
            continue
        boxes = []
        legal = True
        with open(gt, encoding="utf-8-sig") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split(",")
                language = parts[8]
                # only images whose every line is Chinese or Latin
                if language not in ("Chinese", "Latin"):
                    legal = False
                    break
                boxes.append((_quad(parts[:8]),
                              normalize_text(",".join(parts[9:]))))
        if legal:
            yield stem, os.path.join(img_dir, name), boxes


def iter_rects(root: str) -> Iterator[RawSample]:
    img_dir = os.path.join(root, "img")
    gt_dir = os.path.join(root, "gt")
    for name in sorted(os.listdir(img_dir)):
        stem = name.split(".")[0]
        gt = os.path.join(gt_dir, stem + ".json")
        if not os.path.exists(gt):
            continue
        with open(gt, encoding="utf-8") as f:
            records = json.load(f)["chars"]
        boxes = [(_quad(rec["points"]), normalize_text(rec["transcription"]))
                 for rec in records]
        yield stem, os.path.join(img_dir, name), boxes


def standardize_detection_set(raw_iter: Iterator[RawSample], out_dir: str,
                              set_name: str, train_ratio: float = 0.9,
                              max_side: int = 1920, seed: int = 0,
                              log: Optional[Callable[[str], None]] = print
                              ) -> Dict[str, int]:
    samples = {}
    n_seen = n_kept = 0
    for stem, img_path, boxes in raw_iter:
        n_seen += 1
        image = imread_any(img_path)
        result = validate_and_standardize(image, boxes, max_side=max_side)
        if result is None:
            continue
        image, anns = result
        samples[f"{set_name}_{stem}.jpg"] = (image, anns)
        n_kept += 1
    stats = write_standard_set(os.path.join(out_dir, set_name), set_name,
                               samples, train_ratio=train_ratio, seed=seed)
    if log:
        log(f"{set_name}: kept {n_kept}/{n_seen} images -> {stats}")
    stats["seen"] = n_seen
    return stats


def process_rctw(root, out_dir, set_name="ICDAR2017RCTW_text_detection",
                 **kw):
    return standardize_detection_set(iter_rctw(root), out_dir, set_name, **kw)


def process_art(root, out_dir, set_name="ICDAR2019ART_text_detection", **kw):
    return standardize_detection_set(iter_art(root), out_dir, set_name, **kw)


def process_lsvt(root, out_dir, set_name="ICDAR2019LSVT_text_detection",
                 **kw):
    return standardize_detection_set(iter_lsvt(root), out_dir, set_name, **kw)


def process_mlt(root, out_dir, set_name="ICDAR2019MLT_text_detection", **kw):
    return standardize_detection_set(iter_mlt(root), out_dir, set_name, **kw)


def process_rects(root, out_dir, set_name="ICDAR2019ReCTS_text_detection",
                  **kw):
    return standardize_detection_set(iter_rects(root), out_dir, set_name,
                                     **kw)
