"""Text-recognition data (counterpart of
``simpleaicv_tpu/data/text_recognition.py``), without OpenCV:
``CTCTextLabelConverter`` (characters <-> indices, 0 the CTC blank, the
``"reference"`` and ``"superset"`` tables of ``data.char_table``),
``KeepRatioResizeTextRecognitionCollater`` (each image resized to
``resize_h`` high keeping its aspect, right-padded onto a fixed canvas)
and ``FakeTextRecognitionDataset`` (black digit strings on white).

The resize is ``data.transforms.resize_bilinear`` (``F.interpolate``
without antialiasing, OpenCV's ``INTER_LINEAR`` source points on f32), the
text ``data.raster.put_digits`` (OpenCV 5's Hershey simplex, as
``cv2.putText`` draws it).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .raster import put_digits
from .transforms import resize_bilinear

__all__ = ["CTCTextLabelConverter", "KeepRatioResizeTextRecognitionCollater",
           "FakeTextRecognitionDataset"]


class CTCTextLabelConverter:
    """chars <-> indices; index 0 is the CTC blank.

    ``chars`` is an explicit sequence or a named table: ``"reference"``
    (the reference's 12,111 characters, in its order) or ``"superset"``
    (``char_table.final_char_table``)."""

    def __init__(self, chars: Sequence[str] = "reference",
                 str_max_length: int = 80):
        if chars == "reference":
            from .char_table import reference_char_table
            chars = reference_char_table()
        elif chars == "superset":
            from .char_table import final_char_table
            chars = final_char_table()
        self.chars = list(chars)
        self.str_max_length = str_max_length
        self.char_to_idx = {c: i + 1 for i, c in enumerate(self.chars)}
        self.idx_to_char = {i + 1: c for i, c in enumerate(self.chars)}
        self.num_classes = len(self.chars) + 1

    def encode(self, texts: List[str]):
        """texts -> (targets [B, str_max_length] int32, 0-padded, lengths
        [B] int32); unknown characters are dropped, long texts cut."""
        b = len(texts)
        targets = np.zeros((b, self.str_max_length), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, text in enumerate(texts):
            idxs = [self.char_to_idx[c] for c in text
                    if c in self.char_to_idx][:self.str_max_length]
            targets[i, :len(idxs)] = idxs
            lengths[i] = len(idxs)
        return targets, lengths

    def decode(self, pred_indices) -> List[str]:
        """Greedy CTC decode [B, T] -> strings (repeats collapsed, blanks
        dropped)."""
        out = []
        for seq in np.asarray(pred_indices).tolist():
            chars = []
            prev = -1
            for idx in seq:
                if idx != prev and idx != 0:
                    chars.append(self.idx_to_char.get(int(idx), ""))
                prev = idx
            out.append("".join(chars))
        return out


class KeepRatioResizeTextRecognitionCollater:
    """Samples -> {'image' [B, resize_h, max_w, 3] f32 /255, 'targets',
    'target_lengths', 'texts'}: each image resized to ``resize_h`` high and
    round(w * resize_h / h) wide (at most ``max_w``), left-aligned."""

    def __init__(self, converter: CTCTextLabelConverter, resize_h: int = 32,
                 max_w: int = 512):
        self.converter = converter
        self.resize_h = resize_h
        self.max_w = max_w

    def __call__(self, samples):
        n = len(samples)
        images = np.zeros((n, self.resize_h, self.max_w, 3), np.float32)
        texts = []
        for i, s in enumerate(samples):
            img = s["image"]
            h, w = img.shape[:2]
            nw = min(max(int(round(w * self.resize_h / h)), 1), self.max_w)
            img = resize_bilinear(img, self.resize_h, nw)
            images[i, :, :nw] = img / 255.0
            texts.append(s["label"])
        targets, lengths = self.converter.encode(texts)
        return {"image": images, "targets": targets,
                "target_lengths": lengths, "texts": texts}


class FakeTextRecognitionDataset:
    """Synthetic: 3 to 7 digits drawn from ``np.random.RandomState(idx)``,
    black on a white 48 x (36 x n) image (f32 0..255)."""

    def __init__(self, num_samples=64, transform=None):
        self.num_samples = num_samples
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        n_chars = rng.randint(3, 8)
        text = "".join(str(rng.randint(0, 10)) for _ in range(n_chars))
        img = np.full((48, 36 * n_chars, 3), 255, np.uint8)
        put_digits(img, text, (4, 36))
        sample = {"image": img.astype(np.float32), "label": text}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
