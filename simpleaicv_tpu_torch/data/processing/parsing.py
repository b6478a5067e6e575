"""Face/human-parsing raw downloads -> standardized image+mask pair folders
(counterpart of ``simpleaicv_tpu/data/processing/parsing.py``), without
OpenCV.

Output layout (read by ``data/datasets/combined_folder.py``'s
``FaceParsingDataset`` and ``HumanParsingDataset``):
``<out>/<DatasetName>/<set_type>/<DatasetName>_<stem>.jpg`` plus the
same-stem ``.png`` label mask with class indices. A mask of another size
than its image is resized as cv2 ``INTER_NEAREST`` does, at OpenCV's
places (``raster.resize_nearest_index``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Tuple

import numpy as np

from ..raster import resize_nearest_index
from .common import IMREAD_GRAYSCALE, imread_any, imwrite_any

# class-index contracts (the datasets' label semantics)
FACE_SYNTHETICS_NUM_CLASSES = 19   # 0 background .. 18 facewear
CELEBAMASK_HQ_PARTS = [            # part-mask file suffixes; index = pos+1
    "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow", "r_brow",
    "l_ear", "r_ear", "mouth", "u_lip", "l_lip", "hair", "hat",
    "ear_r", "neck_l", "neck", "cloth"]
LIP_NUM_CLASSES = 20               # 0 background .. 19 right_shoe
CIHP_NUM_CLASSES = 20


def _write_pair(out_dir: str, name_stem: str, image: np.ndarray,
                mask: np.ndarray, num_classes: int) -> bool:
    """Validate + write one image/mask pair; returns False when the mask
    holds out-of-range labels (such images are skipped)."""
    if image is None or mask is None:
        return False
    if mask.shape[:2] != image.shape[:2]:
        mask = resize_nearest_index(mask, image.shape[0], image.shape[1])
    mask = mask.copy()
    mask[mask >= 255] = 0
    if int(mask.max(initial=0)) >= num_classes:
        return False
    os.makedirs(out_dir, exist_ok=True)
    imwrite_any(os.path.join(out_dir, name_stem + ".jpg"), image)
    imwrite_any(os.path.join(out_dir, name_stem + ".png"),
                mask.astype(np.uint8))
    return True


def _process_pair_listing(pairs: Iterable[Tuple[str, str, str]],
                          out_dir: str, dataset_name: str,
                          num_classes: int, log=print) -> int:
    n = 0
    for stem, img_path, mask_path in pairs:
        image = imread_any(img_path)
        mask = imread_any(mask_path, IMREAD_GRAYSCALE)
        if _write_pair(out_dir, f"{dataset_name}_{stem}", image, mask,
                       num_classes):
            n += 1
    if log:
        log(f"{out_dir}: {n} pairs")
    return n


def process_face_synthetics(root: str, out_dir: str,
                            dataset_name: str = "FaceSynthetics",
                            log=print) -> Dict[str, int]:
    """root/images_and_annots/<stem>.png + <stem>_seg.png -> train split."""
    src = os.path.join(root, "images_and_annots")
    pairs = []
    for name in sorted(os.listdir(src)):
        if name.endswith(".png") and "_seg" not in name:
            stem = name.split(".")[0]
            seg = os.path.join(src, stem + "_seg.png")
            if os.path.exists(seg):
                pairs.append((stem, os.path.join(src, name), seg))
    n = _process_pair_listing(
        pairs, os.path.join(out_dir, dataset_name, "train"), dataset_name,
        FACE_SYNTHETICS_NUM_CLASSES, log)
    return {"train": n}


def _listed_pairs(img_dir: str, mask_dir: str):
    """(stem, image, mask) of each .jpg in ``img_dir`` with a same-stem
    .png in ``mask_dir``, in name order."""
    pairs = []
    for name in sorted(os.listdir(img_dir)):
        if name.endswith(".jpg"):
            stem = name.split(".")[0]
            mask = os.path.join(mask_dir, stem + ".png")
            if os.path.exists(mask):
                pairs.append((stem, os.path.join(img_dir, name), mask))
    return pairs


def process_lip(root: str, out_dir: str, dataset_name: str = "LIP",
                log=print) -> Dict[str, int]:
    """root/TrainVal_images/{train,val}_images +
    root/TrainVal_parsing_annotations/{train,val}_segmentations."""
    stats = {}
    for set_type in ("train", "val"):
        pairs = _listed_pairs(
            os.path.join(root, "TrainVal_images", f"{set_type}_images"),
            os.path.join(root, "TrainVal_parsing_annotations",
                         f"{set_type}_segmentations"))
        stats[set_type] = _process_pair_listing(
            pairs, os.path.join(out_dir, dataset_name, set_type),
            dataset_name, LIP_NUM_CLASSES, log)
    return stats


def process_cihp(root: str, out_dir: str, dataset_name: str = "CIHP",
                 log=print) -> Dict[str, int]:
    """root/{Training,Validation}/Images + Category_ids."""
    stats = {}
    for src_split, set_type in (("Training", "train"),
                                ("Validation", "val")):
        pairs = _listed_pairs(os.path.join(root, src_split, "Images"),
                              os.path.join(root, src_split, "Category_ids"))
        stats[set_type] = _process_pair_listing(
            pairs, os.path.join(out_dir, dataset_name, set_type),
            dataset_name, CIHP_NUM_CLASSES, log)
    return stats


def _read_celeba_mapping(path: str) -> Dict[int, int]:
    """CelebA-HQ-to-CelebA-mapping.txt (header 'idx orig_idx orig_file'):
    HQ index -> original CelebA index (drives the official train/val/test
    partition)."""
    mapping = {}
    with open(path, encoding="utf-8") as f:
        lines = [ln.split() for ln in f if ln.strip()]
    for row in lines[1:]:  # skip header
        mapping[int(row[0])] = int(row[1])
    return mapping


def process_celebamask_hq(root: str, out_dir: str,
                          dataset_name: str = "CelebAMask-HQ",
                          log=print) -> Dict[str, int]:
    """root/CelebA-HQ-img/<idx>.jpg + root/CelebAMask-HQ-mask-anno/
    <idx//2000>/<%05d>_<part>.png (18 per-part binary masks combined into
    one label mask, part order = class index), split train/val/test by the
    official CelebA partition boundaries (orig_idx <162771 / <182638 /
    rest)."""
    img_dir = os.path.join(root, "CelebA-HQ-img")
    anno_dir = os.path.join(root, "CelebAMask-HQ-mask-anno")
    mapping = _read_celeba_mapping(
        os.path.join(root, "CelebA-HQ-to-CelebA-mapping.txt"))
    stats = {"train": 0, "val": 0, "test": 0}
    for name in sorted(os.listdir(img_dir)):
        if not name.endswith(".jpg"):
            continue
        idx = int(name.split(".")[0])
        image = imread_any(os.path.join(img_dir, name))
        if image is None:
            continue
        mask = np.zeros(image.shape[:2], np.uint8)
        folder = str(idx // 2000)
        for part_pos, part in enumerate(CELEBAMASK_HQ_PARTS):
            part_path = os.path.join(anno_dir, folder,
                                     f"{idx:05d}_{part}.png")
            if not os.path.exists(part_path):
                continue
            pm = imread_any(part_path, IMREAD_GRAYSCALE)
            if pm is None:
                continue
            if pm.shape[:2] != mask.shape:
                pm = resize_nearest_index(pm, mask.shape[0], mask.shape[1])
            mask[pm != 0] = part_pos + 1
        orig = mapping.get(idx, 0)
        set_type = ("val" if 162771 <= orig < 182638 else
                    "test" if orig >= 182638 else "train")
        if _write_pair(os.path.join(out_dir, dataset_name, set_type),
                       f"{dataset_name}_{idx}", image, mask,
                       len(CELEBAMASK_HQ_PARTS) + 1):
            stats[set_type] += 1
    if log:
        log(f"{dataset_name}: {stats}")
    return stats
