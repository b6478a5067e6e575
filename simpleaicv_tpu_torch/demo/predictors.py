"""Single-image SAM predictor of the PyTorch port (counterpart of
``SAMPredictor`` in ``demo/predictors.py``).

One request is one image and one prompt: the image is letterboxed into the
model's square input on the device, encoded, decoded with the prompt, and
the best of the four masks (by predicted IoU) is binarised and resized back
to the image's shape. Point, box and drawn-region prompts are served; no
OpenCV is needed:
  * the letterbox resize is ``F.interpolate(mode="bilinear",
    align_corners=False, antialias=False)``, the taps of cv2 ``INTER_LINEAR``
    on float input;
  * the resize back is ``mode="nearest"``, the floor mapping of cv2
    ``INTER_NEAREST``;
  * a drawn region's bounding rectangle is a numpy nonzero box, as cv2
    ``boundingRect`` computes it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import MODELS
from ..models import interactive_segmentation  # noqa: F401  (registers SAM)
from ..models.common import init_params, resolve_device

__all__ = ["SAMPredictor", "letterbox", "bounding_rect"]


def letterbox(image_rgb: np.ndarray, size: int, device):
    """[h, w, 3] image -> ([size, size, 3] f32 canvas in [0, 1] on
    ``device`` with the image resized into its top-left corner, factor,
    (nh, nw))."""
    h, w = image_rgb.shape[:2]
    factor = size / max(h, w)
    nh, nw = int(round(h * factor)), int(round(w * factor))
    img = torch.from_numpy(np.ascontiguousarray(image_rgb, np.float32))
    img = img.to(device).permute(2, 0, 1)[None]
    resized = F.interpolate(img, size=(nh, nw), mode="bilinear",
                            align_corners=False, antialias=False)
    canvas = torch.zeros(size, size, 3, device=device)
    canvas[:nh, :nw] = resized[0].permute(1, 2, 0) / 255.0
    return canvas, factor, (nh, nw)


def bounding_rect(mask: np.ndarray):
    """(x, y, w, h) of the nonzero pixels of a 2-D mask, (0, 0, 0, 0) when
    it has none (cv2.boundingRect's convention)."""
    ys, xs = np.nonzero(mask)
    if xs.size == 0:
        return 0, 0, 0, 0
    x0, y0 = int(xs.min()), int(ys.min())
    return x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1


def _rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.COLOR_RGB2GRAY on uint8: BT.601 weights in 15-bit fixed point,
    rounded (equal to OpenCV on all 2^24 colours)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


class SAMPredictor:
    """Point-, box- and drawn-region-prompted SAM masks.

    ``network`` names a registered SAM (``sam_b``, ``sam_l``, ``sam_h``).
    Weights are drawn from a ``torch.Generator`` seeded with ``seed``;
    ``core.weights.load_jax_params(predictor.model, params)`` or
    ``predictor.model.load_state_dict`` supply trained ones. Runs on the
    CUDA card unless ``device="cpu"``.
    """

    def __init__(self, network="sam_b", image_size=1024, device="cuda",
                 dtype=torch.bfloat16, seed=0, **model_kwargs):
        self.device = resolve_device(device)
        self.image_size = image_size
        model = MODELS.create(network, image_size=image_size, dtype=dtype,
                              **model_kwargs)
        init_params(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def mask_logits(self, image_rgb: np.ndarray, points_xy=None,
                    box_xyxy=None):
        """Logits [S, S] of the best mask for a point or a box prompt in
        image coordinates, with the letterbox's (nh, nw)."""
        s = self.image_size
        canvas, factor, (nh, nw) = letterbox(image_rgb, s, self.device)
        prompts = {"prompt_point": None, "prompt_box": None,
                   "prompt_mask": None}
        if box_xyxy is not None:
            box = [float(v) * factor for v in box_xyxy]
            prompts["prompt_box"] = torch.tensor([box], device=self.device)
        else:
            pts = np.full((1, 9, 3), -1.0, np.float32)
            for i, (x, y) in enumerate(list(points_xy)[:9]):
                pts[0, i] = [x * factor, y * factor, 1.0]
            prompts["prompt_point"] = torch.from_numpy(pts).to(self.device)
        masks, ious = self.model(canvas[None], prompts, (0, 1, 2, 3))
        best = torch.argmax(ious[0])
        return masks[0, best], (nh, nw)

    def _binary_mask(self, logits, nhw, hw) -> np.ndarray:
        nh, nw = nhw
        mask = (logits > 0).to(torch.uint8)[:nh, :nw]
        mask = F.interpolate(mask[None, None].float(), size=hw,
                             mode="nearest")[0, 0]
        return mask.to(torch.uint8).cpu().numpy()

    def __call__(self, image_rgb: np.ndarray, points_xy) -> np.ndarray:
        """uint8 {0, 1} mask [h, w] for up to 9 positive clicks (x, y)."""
        logits, nhw = self.mask_logits(image_rgb, points_xy=points_xy)
        return self._binary_mask(logits, nhw, image_rgb.shape[:2])

    def predict_box(self, image_rgb: np.ndarray, box_xyxy) -> np.ndarray:
        """uint8 {0, 1} mask [h, w] for a box prompt (x1, y1, x2, y2)."""
        logits, nhw = self.mask_logits(image_rgb, box_xyxy=box_xyxy)
        return self._binary_mask(logits, nhw, image_rgb.shape[:2])

    def predict_region(self, image_rgb: np.ndarray,
                       region_mask: np.ndarray) -> np.ndarray:
        """Drawn-region prompt: the bounding rectangle of the region's
        nonzero pixels becomes the box prompt."""
        m = np.asarray(region_mask)
        if m.ndim == 3:
            m = _rgb_to_gray_u8(m.astype(np.uint8))
        x, y, bw, bh = bounding_rect(m > 0)
        return self.predict_box(image_rgb, (x, y, x + bw, y + bh))
