"""AutoAugment / RandAugment (counterpart of
``simpleaicv_tpu/data/auto_rand_augment.py``): the op tables, the
level-to-argument rules, ``AugmentOp`` with the magnitude-std jitter, the
v0 / v0r / original / originalr ImageNet policies, and the host classes
``AutoAugment`` and ``RandAugment`` for a dataset's transforms.

The JAX package's host classes apply PIL's ops. The port's machine may not
have PIL, so the host classes here apply ``data.device_augment``'s torch
ops to one image on the CPU (PIL's semantics, held against PIL by
``tests/test_torch_device_augment.py``: exact for the geometric and table
ops, within one level for the enhance blends and autocontrast). Draws come
from the global ``random``, as in the JAX package. Samples carry f32 HWC
images in [0, 255].
"""

from __future__ import annotations

import random

import numpy as np

__all__ = ["AutoAugment", "RandAugment", "AugmentOp", "auto_augment_policy"]

_MAX_LEVEL = 10.0
_TRANSLATE_CONST = 250  # reference _HPARAMS_DEFAULT translate_const


def _negate(v):
    return -v if random.random() < 0.5 else v


def _level_to_arg(op_name, level):
    m = level / _MAX_LEVEL
    if op_name in ("ShearX", "ShearY"):
        return _negate(0.3 * m)
    if op_name in ("TranslateX", "TranslateY"):
        return _negate(_TRANSLATE_CONST * m)
    if op_name in ("TranslateXRel", "TranslateYRel"):
        return _negate(0.45 * m)
    if op_name == "Rotate":
        return _negate(30.0 * m)
    if op_name == "Posterize":
        return int(4 * m)
    if op_name == "PosterizeIncreasing":
        return 4 - int(4 * m)
    if op_name == "PosterizeOriginal":
        return int(4 * m) + 4
    if op_name == "Solarize":
        return min(256, int(256 * m))
    if op_name == "SolarizeIncreasing":
        return 256 - min(256, int(256 * m))
    if op_name == "SolarizeAdd":
        return min(128, int(110 * m))
    if op_name in ("Color", "Contrast", "Brightness", "Sharpness"):
        return 1.8 * m + 0.1
    if op_name in ("ColorIncreasing", "ContrastIncreasing",
                   "BrightnessIncreasing", "SharpnessIncreasing"):
        return max(0.1, 1.0 + _negate(0.9 * m))
    return 0


def _apply_named(image, name, arg):
    """Op ``name`` at ``arg`` on one [1, H, W, 3] f32 lattice image."""
    from .device_augment import apply_op
    return apply_op(image, name, arg)


class AugmentOp:
    """(name, prob, magnitude) with the magnitude-std jitter."""

    def __init__(self, name, prob, level, magnitude_std: float = 0.0):
        self.name = name
        self.prob = prob
        self.level = level
        self.magnitude_std = magnitude_std

    def __call__(self, img):
        if self.prob < 1.0 and random.random() > self.prob:
            return img
        level = self.level
        if self.magnitude_std > 0:
            level = random.gauss(level, self.magnitude_std)
        level = min(max(level, 0.0), _MAX_LEVEL)
        return _apply_named(img, self.name, _level_to_arg(self.name, level))


_POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

_POLICY_ORIGINAL = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


def _swap(table, a, b):
    return [[(b if name == a else name, p, m) for name, p, m in sub]
            for sub in table]


_POLICIES = {
    "v0": _POLICY_V0,
    "v0r": _swap(_POLICY_V0, "Posterize", "PosterizeIncreasing"),
    "original": _POLICY_ORIGINAL,
    "originalr": _swap(_POLICY_ORIGINAL, "PosterizeOriginal",
                       "PosterizeIncreasing"),
}


def auto_augment_policy(name: str = "v0", magnitude_std: float = 0.0):
    table = _POLICIES[name]
    return [[AugmentOp(*args, magnitude_std=magnitude_std) for args in sub]
            for sub in table]


def _to_tensor(image):
    """The host path's ``np.clip(image, 0, 255).astype(uint8)`` lattice, as
    a [1, H, W, 3] f32 CPU tensor."""
    import torch
    lattice = np.clip(image, 0, 255).astype(np.uint8).astype(np.float32)
    return torch.from_numpy(lattice)[None]


def _to_np(img):
    return img[0].numpy().astype(np.float32)


class AutoAugment:
    """policy in {'v0', 'v0r', 'original', 'originalr'}: one sub-policy
    drawn per image, its two ops applied in order."""

    def __init__(self, policy: str = "v0", magnitude_std: float = 0.0):
        self.policy = auto_augment_policy(policy, magnitude_std)

    def __call__(self, sample):
        img = _to_tensor(sample["image"])
        for op in random.choice(self.policy):
            img = op(img)
        sample["image"] = _to_np(img)
        return sample


_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]
_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


class RandAugment:
    """RandAugment(N, M) with the magnitude-std jitter and the 'increasing'
    transform set: N ops drawn with replacement, each applied with
    probability ``prob``."""

    def __init__(self, N: int = 2, M: float = 9.0, prob: float = 0.5,
                 magnitude_std: float = 0.5, increasing: bool = True):
        self.N = N
        self.M = M
        self.prob = prob
        self.magnitude_std = magnitude_std
        self.op_names = (_RAND_INCREASING_TRANSFORMS if increasing
                         else _RAND_TRANSFORMS)

    def __call__(self, sample):
        img = _to_tensor(sample["image"])
        for name in random.choices(self.op_names, k=self.N):
            img = AugmentOp(name, self.prob, self.M,
                            magnitude_std=self.magnitude_std)(img)
        sample["image"] = _to_np(img)
        return sample
