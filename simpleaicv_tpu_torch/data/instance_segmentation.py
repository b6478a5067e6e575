"""Instance-segmentation data pipeline (counterpart of
``simpleaicv_tpu/data/instance_segmentation.py``), on the host in numpy.

The collaters give fixed shapes: boxes padded to ``max_annots_num`` slots
with -1, each instance's mask pre-downsampled to the mask-feature grid
(``resize // mask_downsample``, uint8).

The JAX package's three OpenCV resizes are ``torch.nn.functional.interpolate``
on CPU tensors here, without antialiasing, which sample the same source
points and need no OpenCV:
  * the image, ``cv2.resize`` (``INTER_LINEAR``): ``transforms.
    resize_bilinear``, bilinear at pixel centres;
  * each mask, ``INTER_NEAREST``: ``resize_nearest`` (source index
    ``floor(dst * in / out)``);
  * the collaters' downscale of each mask canvas to the mask grid,
    ``INTER_LINEAR`` then ``> 0.5``: bilinear at pixel centres.

The random transforms draw from the global ``random`` and ``numpy.random``
state in the JAX package's order, so seeding the globals alike gives the
JAX sample.
"""

from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as F

from .interactive_segmentation import resize_nearest
from .transforms import resize_bilinear

__all__ = ["InstanceSegmentationResize", "InstanceRandomHorizontalFlip",
           "InstanceNormalize", "SOLOV2InstanceSegmentationCollater",
           "YOLACTInstanceSegmentationCollater",
           "FakeInstanceSegmentationDataset"]


class InstanceSegmentationResize:
    """Resizes the long side to ``resize`` (or, with ``multi_scale``, to a
    multiple of ``stride`` drawn from ``multi_scale_range`` of it), the
    short side rounded; scales the boxes and 'scale' by the factor."""

    def __init__(self, resize=1024, stride=32, resize_type="yolo_style",
                 multi_scale=False, multi_scale_range=(0.8, 1.0)):
        self.resize = resize
        self.stride = stride
        self.multi_scale = multi_scale
        self.multi_scale_range = multi_scale_range

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        if self.multi_scale:
            lo = int(self.multi_scale_range[0] * self.resize)
            hi = int(self.multi_scale_range[1] * self.resize)
            sizes = sorted({i // self.stride * self.stride
                            for i in range(lo, hi + self.stride)})
            final = sizes[np.random.randint(0, len(sizes))]
        else:
            final = self.resize
        factor = final / max(h, w)
        nh, nw = int(round(h * factor)), int(round(w * factor))
        sample["image"] = resize_bilinear(image, nh, nw)
        annots = sample["annots"].copy()
        if annots.shape[0] > 0:
            annots[:, :4] *= factor
        sample["annots"] = annots
        sample["masks"] = [resize_nearest(m, nh, nw) for m in sample["masks"]]
        sample["scale"] = sample.get("scale", 1.0) * np.float32(factor)
        return sample


class InstanceRandomHorizontalFlip:

    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, sample):
        if random.random() < self.prob:
            image = sample["image"]
            w = image.shape[1]
            sample["image"] = np.ascontiguousarray(image[:, ::-1])
            annots = sample["annots"].copy()
            if annots.shape[0] > 0:
                x1 = annots[:, 0].copy()
                annots[:, 0] = w - annots[:, 2]
                annots[:, 2] = w - x1
            sample["annots"] = annots
            sample["masks"] = [np.ascontiguousarray(m[:, ::-1])
                               for m in sample["masks"]]
        return sample


class InstanceNormalize:

    def __call__(self, sample):
        sample["image"] = (sample["image"] / 255.0).astype(np.float32)
        return sample


def _downscale_masks(canvases, mr: int):
    """[n, r, r] f32 canvases -> [n, mr, mr] uint8: bilinear at pixel
    centres without antialiasing (OpenCV's ``INTER_LINEAR``), then > 0.5."""
    t = torch.from_numpy(np.ascontiguousarray(canvases, np.float32))
    out = F.interpolate(t[:, None], size=(mr, mr), mode="bilinear",
                        align_corners=False, antialias=False)[:, 0]
    return (out > 0.5).numpy().astype(np.uint8)


class _InstanceCollaterBase:

    def __init__(self, resize=1024, resize_type="yolo_style",
                 max_annots_num=100, mask_downsample=4,
                 relative_boxes=False):
        if resize_type == "retina_style":
            resize = int(round(resize * 1333.0 / 800))
        self.resize = resize
        self.max_annots_num = max_annots_num
        self.mask_downsample = mask_downsample
        self.relative_boxes = relative_boxes

    def __call__(self, samples):
        n = len(samples)
        r = self.resize
        mr = r // self.mask_downsample
        images = np.zeros((n, r, r, 3), np.float32)
        boxes = np.full((n, self.max_annots_num, 5), -1.0, np.float32)
        masks = np.zeros((n, self.max_annots_num, mr, mr), np.uint8)
        for i, s in enumerate(samples):
            img = s["image"]
            images[i, :img.shape[0], :img.shape[1]] = img
            ann = s["annots"]
            m = min(ann.shape[0], self.max_annots_num)
            if m > 0:
                boxes[i, :m] = ann[:m]
                if self.relative_boxes:
                    boxes[i, :m, :4] /= r
            kept = s["masks"][:self.max_annots_num]
            if kept:
                canvas = np.zeros((len(kept), r, r), np.float32)
                for j, mk in enumerate(kept):
                    canvas[j, :mk.shape[0], :mk.shape[1]] = mk
                masks[i, :len(kept)] = _downscale_masks(canvas, mr)
        return {"image": images, "annots": boxes, "gt_masks": masks}


class SOLOV2InstanceSegmentationCollater(_InstanceCollaterBase):
    """Pixel boxes."""

    def __init__(self, resize=1024, resize_type="yolo_style", **kwargs):
        super().__init__(resize, resize_type, relative_boxes=False, **kwargs)


class YOLACTInstanceSegmentationCollater(_InstanceCollaterBase):
    """Boxes relative to the canvas."""

    def __init__(self, resize=544, resize_type="yolo_style", **kwargs):
        super().__init__(resize, resize_type, relative_boxes=True, **kwargs)


class FakeInstanceSegmentationDataset:
    """Synthetic rectangles with masks, from ``np.random.RandomState(idx)``."""

    def __init__(self, num_samples=16, image_hw=128, num_classes=4,
                 transform=None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.num_classes = num_classes
        self.transform = transform

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        hw = self.image_hw
        image = rng.uniform(0, 50, (hw, hw, 3)).astype(np.float32)
        annots, masks = [], []
        for _ in range(rng.randint(1, 4)):
            w = rng.randint(hw // 6, hw // 2)
            h = rng.randint(hw // 6, hw // 2)
            x, y = rng.randint(0, hw - w), rng.randint(0, hw - h)
            cls = rng.randint(0, self.num_classes)
            image[y:y + h, x:x + w] = 60.0 * (cls + 1)
            mask = np.zeros((hw, hw), np.float32)
            mask[y:y + h, x:x + w] = 1.0
            annots.append([x, y, x + w, y + h, cls])
            masks.append(mask)
        sample = {"image": image, "annots": np.asarray(annots, np.float32),
                  "masks": masks, "scale": np.float32(1.0)}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
