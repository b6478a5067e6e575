"""ImageNet-1K folder dataset (counterpart of
``simpleaicv_tpu/data/datasets/ilsvrc2012.py``): ``<root>/<set_name>/
<class>/<file>``, class ids from the sorted folder names; samples
{"image": [h, w, 3] f32 0..255 RGB, "label": int}.

Files are decoded by the port's libjpeg binding (``data/native_io.py``):
with ``native_decode_hw`` DCT-scaled and stretched to (hw, hw) bilinearly,
as the JAX reader's native path does (the classification Resize
geometry); without it at full size. The JAX reader falls back to cv2 for a
file libjpeg cannot decode (ImageNet's CMYK and PNG-disguised files); the
port has no cv2, so it raises naming the file.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .. import native_io

__all__ = ["ILSVRC2012Dataset", "decode_file"]


def decode_file(path: str, hw: Optional[int] = None) -> np.ndarray:
    """The JPEG at ``path`` as [h, w, 3] f32 RGB, or stretched to (hw, hw);
    raises ``ValueError`` naming the file if it does not decode."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if hw is None:
            return native_io.decode_image(data).astype(np.float32)
        return native_io.decode_resize(data, hw, letterbox=False)
    except ValueError:
        raise ValueError(f"{path}: libjpeg cannot decode this file (the "
                         f"port reads JPEG only)") from None


class ILSVRC2012Dataset:

    def __init__(self, root_dir: str, set_name: str = "train",
                 transform: Optional[Callable] = None,
                 native_decode_hw: Optional[int] = None):
        self.root_dir = root_dir
        self.set_name = set_name
        self.transform = transform
        self.native_decode_hw = native_decode_hw
        self._items = None
        self._class_to_idx = None

    def _scan(self):
        if self._items is not None:
            return
        split_dir = os.path.join(self.root_dir, self.set_name)
        classes = sorted(d for d in os.listdir(split_dir)
                         if os.path.isdir(os.path.join(split_dir, d)))
        self._class_to_idx = {c: i for i, c in enumerate(classes)}
        items = []
        for c in classes:
            cdir = os.path.join(split_dir, c)
            for fname in sorted(os.listdir(cdir)):
                items.append((os.path.join(cdir, fname),
                              self._class_to_idx[c]))
        self._items = items

    def __len__(self):
        self._scan()
        return len(self._items)

    def __getitem__(self, idx):
        self._scan()
        path, label = self._items[idx]
        sample = {"image": decode_file(path, self.native_decode_hw),
                  "label": int(label)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
