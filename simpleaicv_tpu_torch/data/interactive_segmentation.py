"""SAM data pipeline (counterpart of
``simpleaicv_tpu/data/interactive_segmentation.py``), without OpenCV:
``SamResize``, ``noise_bbox``, ``SAMBatchCollater`` and
``FakeSAMSegmentationDataset`` and ``SAMMattingCollater``.

Against the JAX package, which draws from the global ``random`` and
``numpy.random`` state, the collaters and ``noise_bbox`` draw from a
``random.Random`` and a ``numpy.random.RandomState`` that the caller passes
in, in the same order, so two runs seeded alike give the same batch.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .transforms import resize_bilinear

__all__ = ["SamResize", "noise_bbox", "SAMBatchCollater",
           "FakeSAMSegmentationDataset", "SAMMattingCollater"]


def resize_nearest(mask, out_h: int, out_w: int):
    """[h, w] -> [out_h, out_w] f32 by nearest neighbour: source index
    floor(dst * in / out), OpenCV's ``INTER_NEAREST``."""
    t = torch.from_numpy(np.ascontiguousarray(mask, np.float32))
    return F.interpolate(t[None, None], size=(out_h, out_w),
                         mode="nearest")[0, 0].numpy()


class SamResize:
    """Resizes the long side to ``resize`` (the short side rounded to the
    nearest pixel): the image bilinearly at pixel centres, the mask by
    nearest neighbour; multiplies 'scale' by the factor. The collater pads
    both onto its square canvas."""

    def __init__(self, resize=1024):
        self.resize = resize

    def __call__(self, sample):
        image, mask = sample["image"], sample["mask"]
        h, w = image.shape[:2]
        factor = self.resize / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        sample["image"] = resize_bilinear(image, nh, nw)
        sample["mask"] = resize_nearest(mask, nh, nw)
        sample["scale"] = sample.get("scale", 1.0) * np.float32(factor)
        return sample


def noise_bbox(box, h, w, np_rng, std_ratio=0.1, max_offset=20):
    """Jitters the corners of an (x1, y1, x2, y2) box by N(0, 0.1 * side)
    clipped to 20 px, keeping it inside the h x w canvas and at least one
    pixel wide and high; four normal draws from ``np_rng``."""
    x1, y1, x2, y2 = box
    bw, bh = x2 - x1, y2 - y1
    noise = np.clip(np_rng.randn(4) * std_ratio * np.array([bw, bh, bw, bh]),
                    -max_offset, max_offset)
    x1 = np.clip(x1 + noise[0], 0, w - 1)
    y1 = np.clip(y1 + noise[1], 0, h - 1)
    x2 = np.clip(x2 + noise[2], x1 + 1, w)
    y2 = np.clip(y2 + noise[3], y1 + 1, h)
    return np.array([x1, y1, x2, y2], np.float32)


def _draw_prompts(collater, fg, points, box):
    """Fills ``points`` [max_points, 3] with 1 to 9 positive clicks drawn
    inside the boolean mask ``fg`` and ``box`` [4] with its box, jittered by
    ``noise_bbox`` unless the collater's ``use_noise_bbox`` is False, from
    the collater's generators; leaves both alone when ``fg`` is empty."""
    ys, xs = np.nonzero(fg)
    if len(ys) == 0:
        return
    k = min(collater.rng.randint(*collater.point_range), collater.max_points,
            len(ys))
    sel = collater.np_rng.choice(len(ys), k, replace=False)
    points[:k, 0] = xs[sel]
    points[:k, 1] = ys[sel]
    points[:k, 2] = 1.0
    b = np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float32)
    r = collater.resize
    box[:] = (noise_bbox(b, r, r, collater.np_rng) if collater.use_noise_bbox
              else b)


class SAMBatchCollater:
    """Builds fixed-shape batches from samples ``{"image": [h, w, 3] in
    0..255, "mask": [h, w]}`` no larger than the canvas:
      image        [B, resize, resize, 3] in 0..1, zero-padded
      mask         [B, resize, resize] binary ground truth
      prompt_point [B, max_points, 3] (x, y, label; -1 padding), 1 to 9
                   positive clicks drawn inside the mask
      prompt_box   [B, 4] the mask's box, jittered by ``noise_bbox``
      prompt_mask  [B, s, s, 1] the mask at s = resize // 4 (every fourth
                   pixel, which is what a nearest-neighbour resize by 4
                   takes)
    ``rng`` (a ``random.Random``) draws the number of clicks and ``np_rng``
    (a ``numpy.random.RandomState``) the clicks and the box noise; without
    them the collater makes its own from seed 0.
    """

    def __init__(self, resize=1024, positive_point_num_range=(1, 9),
                 max_points: int = 9, use_noise_bbox=True,
                 rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        if resize % 4:
            raise ValueError(f"resize must be a multiple of 4, got {resize}")
        self.resize = resize
        self.point_range = positive_point_num_range
        self.max_points = max_points
        self.use_noise_bbox = use_noise_bbox
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = (np_rng if np_rng is not None
                       else np.random.RandomState(0))

    def __call__(self, samples):
        n = len(samples)
        r = self.resize
        images = np.zeros((n, r, r, 3), np.float32)
        masks = np.zeros((n, r, r), np.float32)
        points = np.full((n, self.max_points, 3), -1.0, np.float32)
        boxes = np.zeros((n, 4), np.float32)

        for i, s in enumerate(samples):
            img, m = s["image"], s["mask"]
            h, w = img.shape[:2]
            if h > r or w > r:
                raise ValueError(f"sample {i} is {h}x{w}, the canvas {r}x{r}")
            images[i, :h, :w] = img / 255.0
            masks[i, :h, :w] = m

            _draw_prompts(self, masks[i] != 0, points[i], boxes[i])

        return {"image": images, "mask": masks, "prompt_point": points,
                "prompt_box": boxes,
                "prompt_mask": np.ascontiguousarray(
                    masks[:, ::4, ::4, None])}


class FakeSAMSegmentationDataset:
    """Synthetic samples: noise with one bright filled ellipse as the object
    and the ellipse as the mask, from a generator seeded by the index.

    The ellipse is the set of pixels with ((x - cx) / ax)^2 +
    ((y - cy) / ay)^2 <= 1. The JAX package rasterises it with
    ``cv2.ellipse``, whose polygon approximation may differ from this
    inequality on boundary pixels; the centre, the axes and the noise are
    drawn alike.
    """

    def __init__(self, num_samples=32, image_hw=256, transform=None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        hw = self.image_hw
        image = rng.uniform(0, 60, (hw, hw, 3)).astype(np.float32)
        cx, cy = rng.randint(hw // 4, 3 * hw // 4, 2)
        ax, ay = rng.randint(hw // 8, hw // 3, 2)
        ys, xs = np.mgrid[:hw, :hw]
        inside = (((xs - cx) / ax)**2 + ((ys - cy) / ay)**2) <= 1.0
        mask = inside.astype(np.float32)
        image[inside] = 220.0
        sample = {"image": image, "mask": mask}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class SAMMattingCollater:
    """SAM-matting batches from matting samples (``{"image", "alpha",
    "trimap"}``, no larger than the canvas):
      image        [B, resize, resize, 3], divided by 255 only when its
                   largest value is above 1.5, zero-padded
      alpha        [B, resize, resize]
      trimap       [B, resize, resize] with values {0, 128, 255}
      prompt_point [B, max_points, 3] (x, y, label; -1 padding), 1 to 9
                   positive clicks drawn where alpha > 0.5
      prompt_box   [B, 4] the box of alpha > 0.5, jittered by
                   ``noise_bbox`` unless ``use_noise_bbox`` is False
    ``rng`` draws the number of clicks and ``np_rng`` the clicks and the box
    noise, as in ``SAMBatchCollater``.
    """

    def __init__(self, resize=1024, positive_point_num_range=(1, 9),
                 max_points: int = 9, use_noise_bbox=True,
                 rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        self.resize = resize
        self.point_range = positive_point_num_range
        self.max_points = max_points
        self.use_noise_bbox = use_noise_bbox
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = (np_rng if np_rng is not None
                       else np.random.RandomState(0))

    def __call__(self, samples):
        n, r = len(samples), self.resize
        images = np.zeros((n, r, r, 3), np.float32)
        alphas = np.zeros((n, r, r), np.float32)
        trimaps = np.zeros((n, r, r), np.float32)
        points = np.full((n, self.max_points, 3), -1.0, np.float32)
        boxes = np.zeros((n, 4), np.float32)

        for i, s in enumerate(samples):
            img = s["image"]
            h, w = img.shape[:2]
            images[i, :h, :w] = img if img.max() <= 1.5 else img / 255.0
            alphas[i, :h, :w] = s["alpha"]
            trimaps[i, :h, :w] = s["trimap"]
            _draw_prompts(self, alphas[i] > 0.5, points[i], boxes[i])
        return {"image": images, "alpha": alphas, "trimap": trimaps,
                "prompt_point": points, "prompt_box": boxes}
