"""The port's dataset preparation (``simpleaicv_tpu_torch/data/processing``
and the twelve conversion subcommands of ``simpleaicv_tpu_torch/tools/
prepare_dataset.py``) against the JAX tool (``tools/prepare_dataset.py``,
which converts with cv2), on raw trees the test writes in each source's
layout:

* each subcommand runs through both tools' ``main``; the two output trees
  hold the same files, their JSON is equal (numbers within 1e-9), their
  PNGs decode to the same pixels and their JPEGs are the same bytes;
* the port's readers over the port's trees give the JAX readers' samples
  over the JAX trees (``TextDetection``, ``TextRecognition``,
  ``HumanParsingDataset``, ``FaceParsingDataset``,
  ``SAMSegmentationDataset``);
* ``validate_and_standardize`` accepts and rejects what the JAX function
  does, with the same image and annotations where it accepts;
* the port's parser has the JAX parser's subcommands, flags and defaults.

The raw trees cover RCTW's quoted transcripts with commas and its skipped
``image_6089.jpg``, an illegible ART line, MLT's language filter, curved
(6-point), odd (5-point: the minimum-area-rectangle fallback) and
vertical text lines, masks of another size than their image (the nearest
resize), out-of-range labels and mask values of 127 and 128 about the
SA-1B threshold.
"""

import argparse
import importlib.util
import json
import os
import random
from pathlib import Path

import cv2
import numpy as np
import pytest

from simpleaicv_tpu.data.datasets import combined_folder as jax_folder
from simpleaicv_tpu.data.datasets import sam_segmentation as jax_sam
from simpleaicv_tpu.data.datasets import text as jax_text
from simpleaicv_tpu.data.processing import common as jax_common
from simpleaicv_tpu_torch.data.datasets import (
    FaceParsingDataset, HumanParsingDataset, SAMSegmentationDataset,
    TextDetection, TextRecognition)
from simpleaicv_tpu_torch.data.processing import common
from simpleaicv_tpu_torch.tools import prepare_dataset

from _torch_port import assert_samples_equal, one_torch_thread

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_dataset", REPO / "tools" / "prepare_dataset.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------ raw trees

BOX_A = [[20, 20], [120, 20], [120, 60], [20, 60]]
BOX_B = [[150, 100], [280, 100], [280, 150], [150, 150]]
CURVE = [[30, 170], [90, 160], [150, 170], [150, 200], [90, 190], [30, 200]]
PENTAGON = [[180, 20], [240, 15], [300, 25], [300, 60], [180, 60]]
VERTICAL = [[290, 70], [315, 70], [315, 230], [290, 230]]


def _canvas(h=240, w=320, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
    return cv2.GaussianBlur(img, (3, 3), 0)


def _flat(box):
    return ",".join(str(v) for c in box for v in c)


def _write_rctw(root):
    (root / "train_images").mkdir(parents=True)
    (root / "train_gts").mkdir()
    for i, name in enumerate(["image_0", "image_1", "image_2", "image_6089"]):
        cv2.imwrite(str(root / "train_images" / f"{name}.jpg"),
                    _canvas(seed=i))
        rows = [f'{_flat(BOX_A)},0,"ｈｅｌｌo,w"', f'{_flat(BOX_B)},1,"###"']
        if i == 2:  # an empty transcript rejects the image
            rows.append(f'{_flat(VERTICAL)},0,""')
        (root / "train_gts" / f"{name}.txt").write_text(
            "\n".join(rows) + "\n", encoding="utf-8-sig")


def _json_tree(root, img_dir, label_file):
    (root / img_dir).mkdir(parents=True)
    labels = {}
    for i in range(3):
        cv2.imwrite(str(root / img_dir / f"gt_{i}.jpg"), _canvas(seed=10 + i))
        labels[f"gt_{i}"] = [
            {"points": BOX_A, "transcription": "你好"},
            {"points": BOX_B, "transcription": "bad", "illegibility": True},
            {"points": CURVE, "transcription": "ｃｕｒｖｅ"},
            {"points": PENTAGON, "transcription": "five"},
            {"points": VERTICAL, "transcription": "竖排"}]
    labels["gt_2"].append({"points": [[1, 1], [2, 2], [3, 1]],
                           "transcription": "x"})  # too few points
    (root / label_file).write_text(json.dumps(labels, ensure_ascii=False),
                                   encoding="utf-8")


def _write_mlt(root):
    (root / "train_images").mkdir(parents=True)
    (root / "train_gts").mkdir()
    gts = {"img_0": f"{_flat(BOX_A)},Latin,word\n{_flat(BOX_B)},Chinese,字",
           "img_1": f"{_flat(BOX_A)},Arabic,xxx",
           "img_2": f"{_flat(BOX_A)},Latin,a,b\n{_flat(VERTICAL)},Latin,###"}
    for i, (stem, text) in enumerate(gts.items()):
        cv2.imwrite(str(root / "train_images" / f"{stem}.jpg"),
                    _canvas(seed=20 + i))
        (root / "train_gts" / f"{stem}.txt").write_text(text,
                                                         encoding="utf-8")


def _write_rects(root):
    (root / "img").mkdir(parents=True)
    (root / "gt").mkdir()
    flat = lambda b: [v for c in b for v in c]  # noqa: E731
    for i in range(2):
        cv2.imwrite(str(root / "img" / f"r{i}.jpg"),
                    _canvas(300, 260, seed=30 + i))
        (root / "gt" / f"r{i}.json").write_text(json.dumps({
            "chars": [{"points": flat(BOX_A), "transcription": "字"},
                      {"points": flat(BOX_B), "transcription": "（文）"}]}),
            encoding="utf-8")


def _mask(h, w, seed, labels):
    rng = np.random.RandomState(seed)
    mask = np.zeros((h, w), np.uint8)
    for v in labels:
        y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
        mask[y:y + rng.randint(4, h // 2), x:x + rng.randint(4, w // 2)] = v
    return mask


def _write_parsing(root):
    fs = root / "fs" / "images_and_annots"
    fs.mkdir(parents=True)
    for i, (hw, seg_hw) in enumerate([((48, 48), (48, 48)),
                                      ((60, 44), (30, 22))]):
        cv2.imwrite(str(fs / f"00000{i}.png"), _canvas(*hw, seed=40 + i))
        cv2.imwrite(str(fs / f"00000{i}_seg.png"),
                    _mask(*seg_hw, 40 + i, [1, 7, 18, 255]))
    lip = root / "lip"
    for st in ("train", "val"):
        img_dir = lip / "TrainVal_images" / f"{st}_images"
        seg_dir = lip / "TrainVal_parsing_annotations" / f"{st}_segmentations"
        img_dir.mkdir(parents=True)
        seg_dir.mkdir(parents=True)
        for i, (hw, seg_hw, labels) in enumerate([
                ((64, 48), (64, 48), [13, 2]), ((70, 50), (35, 25), [5, 19]),
                ((64, 64), (64, 64), [99])]):
            cv2.imwrite(str(img_dir / f"p{i}.jpg"), _canvas(*hw, seed=50 + i))
            cv2.imwrite(str(seg_dir / f"p{i}.png"), _mask(*seg_hw, 50 + i,
                                                          labels))
    cihp = root / "cihp"
    for split in ("Training", "Validation"):
        (cihp / split / "Images").mkdir(parents=True)
        (cihp / split / "Category_ids").mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(cihp / split / "Images" / f"{i:07d}.jpg"),
                        _canvas(56, 40, seed=60 + i))
            cv2.imwrite(str(cihp / split / "Category_ids" / f"{i:07d}.png"),
                        _mask(56 // (i + 1), 40 // (i + 1), 60 + i, [3, 14]))
    cm = root / "celebamask"
    (cm / "CelebA-HQ-img").mkdir(parents=True)
    (cm / "CelebAMask-HQ-mask-anno" / "0").mkdir(parents=True)
    for idx in range(3):
        cv2.imwrite(str(cm / "CelebA-HQ-img" / f"{idx}.jpg"),
                    _canvas(64, 64, seed=70 + idx))
        side = 64 if idx != 1 else 32  # part masks at another size
        for k, part in enumerate(["skin", "hair", "cloth"]):
            cv2.imwrite(str(cm / "CelebAMask-HQ-mask-anno" / "0" /
                            f"{idx:05d}_{part}.png"),
                        _mask(side, side, 70 + 3 * idx + k, [255]))
    (cm / "CelebA-HQ-to-CelebA-mapping.txt").write_text(
        "idx orig_idx orig_file\n0 5 a.jpg\n1 170000 b.jpg\n"
        "2 190000 c.jpg\n")


def _write_mask_pairs(root):
    for st, sizes in (("train", [(96, 128), (75, 180), (120, 90)]),
                      ("test", [(64, 100)])):
        d = root / st
        d.mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            cv2.imwrite(str(d / f"s{i}.jpg"), _canvas(h, w, seed=80 + i))
            mask = _mask(h, w, 80 + i, [255, 128, 127, 200])
            cv2.imwrite(str(d / f"s{i}.png"), mask)
        cv2.imwrite(str(d / "lonely.jpg"), _canvas(32, 32))  # no mask


def _raw_trees(root):
    _write_rctw(root / "rctw")
    _json_tree(root / "art", "train_images", "train_labels.json")
    _json_tree(root / "lsvt", "train_full_images", "train_full_labels.json")
    _write_mlt(root / "mlt")
    _write_rects(root / "rects")
    _write_parsing(root)
    _write_mask_pairs(root / "pairs")


def _runs(raw, out):
    """(name, argv list) of the twelve subcommands, in the order that
    feeds ``text-lines`` and ``char-table`` from the detection sets."""
    det = out / "det"
    lines = out / "lines"
    rctw, art = (lines / f"ICDAR{s}_text_recognition"
                 for s in ("2017RCTW", "2019ART"))
    rec = [str(rctw / f"{rctw.name}_{t}.json") for t in ("train", "test")]
    rec.append(str(art / f"{art.name}_train.json"))
    return [
        ("rctw", [["rctw", "--root", str(raw / "rctw"), "--out", str(det)]]),
        ("art", [["art", "--root", str(raw / "art"), "--out", str(det),
                  "--max-side", "640", "--train-ratio", "1.0"]]),
        ("lsvt", [["lsvt", "--root", str(raw / "lsvt"), "--out", str(det),
                   "--max-side", "400", "--seed", "3",
                   "--train-ratio", "0.5"]]),
        ("mlt", [["mlt", "--root", str(raw / "mlt"), "--out", str(det),
                  "--max-side", "320", "--train-ratio", "0.5"]]),
        ("rects", [["rects", "--root", str(raw / "rects"), "--out",
                    str(det), "--max-side", "300"]]),
        ("text-lines", [
            ["text-lines", "--root", str(det), "--set-name",
             "ICDAR2017RCTW_text_detection", "--out", str(rctw)],
            ["text-lines", "--root", str(det), "--set-name",
             "ICDAR2019ART_text_detection", "--out", str(art)]]),
        ("char-table", [["char-table", "--labels", *rec, "--out",
                         str(out / "table.json")]]),
        ("face-synthetics", [["face-synthetics", "--root", str(raw / "fs"),
                              "--out", str(out / "parsing")]]),
        ("celebamask-hq", [["celebamask-hq", "--root",
                            str(raw / "celebamask"), "--out",
                            str(out / "parsing")]]),
        ("lip", [["lip", "--root", str(raw / "lip"), "--out",
                  str(out / "parsing")]]),
        ("cihp", [["cihp", "--root", str(raw / "cihp"), "--out",
                   str(out / "parsing")]]),
        ("sam-masks", [["sam-masks", "--root", str(raw / "pairs"), "--out",
                        str(out / "sa1b" / "pairs"), "--set-type", st]
                       for st in ("train", "test")]),
    ]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The raw trees, and the JAX tool's and the port's outputs of all
    twelve subcommands: {"raw", "jax", "port"} paths."""
    base = tmp_path_factory.mktemp("processing")
    _raw_trees(base / "raw")
    jax_main = _jax_tool().main
    for tool, main in (("jax", jax_main), ("port", prepare_dataset.main)):
        for _, argvs in _runs(base / "raw", base / tool):
            for argv in argvs:
                assert main(argv) == 0
    return {k: base / k for k in ("raw", "jax", "port")}


# ------------------------------------------------------ tree comparison

def _outputs(out, name):
    """The files under ``out`` that subcommand ``name`` writes."""
    parts = {"rctw": "det/ICDAR2017RCTW_text_detection",
             "art": "det/ICDAR2019ART_text_detection",
             "lsvt": "det/ICDAR2019LSVT_text_detection",
             "mlt": "det/ICDAR2019MLT_text_detection",
             "rects": "det/ICDAR2019ReCTS_text_detection",
             "text-lines": "lines", "char-table": "table.json",
             "face-synthetics": "parsing/FaceSynthetics",
             "celebamask-hq": "parsing/CelebAMask-HQ",
             "lip": "parsing/LIP", "cihp": "parsing/CIHP",
             "sam-masks": "sa1b"}
    top = out / parts[name]
    if top.is_file():
        return {top.name}
    return {str(p.relative_to(out)) for p in top.rglob("*") if p.is_file()}


def _assert_json_equal(a, b, where):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _assert_json_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_equal(x, y, f"{where}[{i}]")
    elif isinstance(b, float) and not isinstance(b, bool):
        assert isinstance(a, (int, float)) and abs(a - b) <= 1e-9, (
            where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# files each subcommand must write at least, so that a tool that writes
# nothing cannot pass
MIN_FILES = {"rctw": 4, "art": 4, "lsvt": 4, "mlt": 4, "rects": 3,
             "text-lines": 14, "char-table": 1, "face-synthetics": 4,
             "celebamask-hq": 6, "lip": 8, "cihp": 8, "sam-masks": 8}


@pytest.mark.parametrize("name", list(MIN_FILES))
def test_subcommand_writes_the_jax_tree(trees, name):
    mine, theirs = (_outputs(trees[k], name) for k in ("port", "jax"))
    assert mine == theirs, (name, sorted(mine ^ theirs))
    assert len(theirs) >= MIN_FILES[name], sorted(theirs)
    for rel in sorted(theirs):
        a, b = trees["port"] / rel, trees["jax"] / rel
        if rel.endswith(".json"):
            with open(a, encoding="utf-8") as fa, \
                    open(b, encoding="utf-8") as fb:
                _assert_json_equal(json.load(fa), json.load(fb), rel)
        elif rel.endswith(".png"):
            got = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
            want = cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype and got.shape == want.shape, rel
            np.testing.assert_array_equal(got, want, err_msg=rel)
        else:
            assert rel.endswith(".jpg"), rel
            assert a.read_bytes() == b.read_bytes(), rel


def test_text_lines_cover_curves_fallback_and_rotation(trees):
    art = trees["port"] / "lines" / "ICDAR2019ART_text_recognition"
    with open(art / f"{art.name}_train.json", encoding="utf-8") as f:
        labels = json.load(f)
    assert set(labels.values()) == {"你好", "curve", "five", "竖排"}
    for name, text in labels.items():
        h, w = cv2.imread(str(art / "train" / name)).shape[:2]
        assert w >= h, (name, text)  # the vertical line was rotated
    with open(trees["port"] / "table.json", encoding="utf-8") as f:
        assert json.load(f) == sorted(set("hello,w你好curvefive竖排"))


# ----------------------------------------------------------------- readers

def _pairs(cls, jax_cls, root_port, root_jax, sets, set_type):
    mine = cls(str(root_port), sets, set_type=set_type)
    theirs = jax_cls(str(root_jax), sets, set_type=set_type)
    assert len(mine) == len(theirs) > 0
    return [(mine[i], theirs[i]) for i in range(len(theirs))]


@pytest.mark.parametrize("kind", ["detection", "recognition", "human",
                                  "face", "sam"])
def test_port_readers_read_the_port_tree_as_jax_reads_its_own(trees, kind):
    port, jax = trees["port"], trees["jax"]
    if kind == "detection":
        sets = ["ICDAR2017RCTW_text_detection", "ICDAR2019ART_text_detection",
                "ICDAR2019ReCTS_text_detection"]
        pairs = [p for t in ("train", "test") for p in _pairs(
            TextDetection, jax_text.TextDetection, port / "det", jax / "det",
            sets, t)]
    elif kind == "recognition":
        pairs = _pairs(TextRecognition, jax_text.TextRecognition,
                       port / "lines", jax / "lines",
                       ["ICDAR2017RCTW_text_recognition",
                        "ICDAR2019ART_text_recognition"], "train")
    elif kind in ("human", "face"):
        cls, jax_cls, sets = (
            (HumanParsingDataset, jax_folder.HumanParsingDataset,
             ["LIP", "CIHP"]) if kind == "human" else
            (FaceParsingDataset, jax_folder.FaceParsingDataset,
             ["FaceSynthetics", "CelebAMask-HQ"]))
        pairs = [p for t in ("train", "val") for p in _pairs(
            cls, jax_cls, port / "parsing", jax / "parsing", sets, t)
            if t == "train" or kind == "human"]
    else:
        mine = SAMSegmentationDataset(str(port / "sa1b"), ["pairs"],
                                      set_type="train",
                                      rng=random.Random(7))
        random.seed(7)
        theirs = jax_sam.SAMSegmentationDataset(str(jax / "sa1b"), ["pairs"],
                                                set_type="train")
        assert len(mine) == len(theirs) == 3
        pairs = [(mine[i], theirs[i]) for i in range(3)]
    for i, (got, want) in enumerate(pairs):
        assert_samples_equal(got, want, f"{kind} {i}")


# ------------------------------------------------------- the validity rule

def _validity_cases():
    """The JAX package's own rejection cases of
    ``tests/test_dataset_processing.py``, and an accepted one."""
    bowtie = [[20, 20], [80, 80], [80, 20], [20, 80]]
    dot = [[20, 20], [22, 20], [22, 22], [20, 22]]
    near = [[c[0] + 4, c[1] + 4] for c in BOX_A]
    img = _canvas()
    return {"accepted": (img, [(BOX_A, "hello")]),
            "accepted_two": (img, [(BOX_A, "a"), (BOX_B, "b")]),
            "empty_transcript": (img, [(BOX_A, "")]),
            "self_intersecting": (img, [(bowtie, "x")]),
            "under_min_area": (img, [(dot, "x")]),
            "shrunk_overlap": (img, [(BOX_A, "a"), (near, "b")]),
            "too_small_image": (_canvas(60, 60), [(BOX_A, "a")])}


@pytest.mark.parametrize("case", list(_validity_cases()))
def test_validate_and_standardize_decides_as_jax(case):
    image, boxes = _validity_cases()[case]
    want = jax_common.validate_and_standardize(image[..., ::-1].copy(),
                                               boxes, max_side=320)
    got = common.validate_and_standardize(image, boxes, max_side=320)
    assert (got is None) == (want is None)
    assert (got is not None) == case.startswith("accepted")
    if want is not None:
        np.testing.assert_array_equal(got[0], want[0][..., ::-1])
        _assert_json_equal(got[1], want[1], case)


# ------------------------------------------------------------------ parser

def _parser_of(main):
    """The subcommands of the argparse parser that ``main`` builds:
    {name: {dest: (flags, default, required, nargs, type, choices)}}."""
    class Caught(Exception):
        pass

    def catch(self, *args, **kwargs):
        raise Caught(self)

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        main(["rctw"])
    except Caught as e:
        parser = e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = original
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.required,
                            a.nargs, a.type, a.choices)
                   for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_parser_has_the_jax_subcommands_and_defaults():
    mine, theirs = _parser_of(prepare_dataset.main), \
        _parser_of(_jax_tool().main)
    assert sorted(mine) == sorted(theirs) and len(theirs) == 16
    assert mine == theirs
