"""DBNet's text-detection data and decoder (counterpart of
``simpleaicv_tpu/data/text_detection.py``), without OpenCV: every cv2 call
there is a ``data.raster`` function here.

``DBNetMapGenerator`` makes the probability map (each polygon eroded by
the DB offset d = A (1 - r^2) / L with an elliptic element), its ignore
map (ignored polygons and those under area 16 cleared), the threshold map
(1 - the 3x3-chamfer distance to the polygon's outline over max(d, 1),
inside the polygon dilated by d, scaled to [0.3, 0.7]) and its ignore
map (the dilated band). Each polygon's maps are computed on a window of
the image around it, wide enough that the erosion, the dilation and the
distances on the band are those of the whole image (the JAX package
computes two more distance transforms that nothing reads; they are not
computed here). ``TextDetectionCollater`` pads onto square canvases;
``FakeTextDetectionDataset`` draws bright rectangles; ``DBNetDecoder``
thresholds the probability map, follows its contours and unclips them
(``ops.polygon``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops.polygon import clip_polygon_to_rect, offset_polygon, \
    unclip_distance
from .raster import (approx_poly_dp, arc_length, box_points, contour_area,
                     dilate, distance_transform_l2_3, ellipse_element, erode,
                     fill_poly, find_contours, min_area_rect, polylines)

__all__ = ["DBNetMapGenerator", "TextDetectionCollater",
           "FakeTextDetectionDataset", "DBNetDecoder"]


def _poly_offset_distance(poly: np.ndarray, shrink_ratio: float) -> float:
    area = contour_area(poly.astype(np.float32))
    peri = arc_length(poly.astype(np.float32))
    if peri < 1e-4:
        return 0.0
    return area * (1.0 - shrink_ratio**2) / peri


def _disk_radius(d: float) -> int:
    return max(int(round(d)), 1)


class DBNetMapGenerator:
    """Sample {'image', 'annots': list of [N, 2] polygons, 'ignore_flags'}
    -> adds 'probability_mask', 'probability_ignore_mask',
    'threshold_mask' and 'threshold_ignore_mask' ([h, w] f32 each)."""

    def __init__(self, shrink_ratio=0.4, thresh_min=0.3, thresh_max=0.7):
        self.shrink_ratio = shrink_ratio
        self.thresh_min = thresh_min
        self.thresh_max = thresh_max

    def __call__(self, sample):
        image = sample["image"]
        h, w = image.shape[:2]
        polys: List[np.ndarray] = sample.get("annots", [])
        ignore_flags = sample.get("ignore_flags", [False] * len(polys))

        prob_mask = np.zeros((h, w), np.float32)
        prob_ignore = np.ones((h, w), np.float32)
        thresh_mask = np.zeros((h, w), np.float32)
        thresh_ignore = np.zeros((h, w), np.float32)

        for poly, ignore in zip(polys, ignore_flags):
            poly = np.asarray(poly, np.int32)
            if ignore or contour_area(poly.astype(np.float32)) < 16:
                fill_poly(prob_ignore, poly, 0.0)
                continue
            d = _poly_offset_distance(poly, self.shrink_ratio)
            r = _disk_radius(d)
            element = ellipse_element(2 * r + 1)
            # the window: the polygon's box and r + 2 pixels around it
            y0 = max(int(poly[:, 1].min()) - r - 2, 0)
            y1 = min(int(poly[:, 1].max()) + r + 3, h)
            x0 = max(int(poly[:, 0].min()) - r - 2, 0)
            x1 = min(int(poly[:, 0].max()) + r + 3, w)
            if y0 >= y1 or x0 >= x1:
                continue
            local = poly - np.array([x0, y0], np.int32)
            win = (slice(y0, y1), slice(x0, x1))
            full = fill_poly(np.zeros((y1 - y0, x1 - x0), np.uint8), local, 1)
            shrunk = erode(full, element) if d >= 1 else full
            prob_mask[win] = np.maximum(prob_mask[win],
                                        shrunk.astype(np.float32))
            band = dilate(full, element).astype(np.float32)
            edge = polylines(np.zeros_like(full), local, 1)
            dist_edge = distance_transform_l2_3(1 - edge)
            tval = np.clip(1.0 - dist_edge / max(d, 1.0), 0.0, 1.0)
            thresh_mask[win] = np.maximum(thresh_mask[win], tval * band)
            thresh_ignore[win] = np.maximum(thresh_ignore[win], band)

        thresh_mask = thresh_mask * (self.thresh_max -
                                     self.thresh_min) + self.thresh_min
        sample["probability_mask"] = prob_mask
        sample["probability_ignore_mask"] = prob_ignore
        sample["threshold_mask"] = thresh_mask
        sample["threshold_ignore_mask"] = thresh_ignore
        return sample


class TextDetectionCollater:
    """Samples -> a batch on resize x resize canvases (top-left, zero
    padded): 'image' /255 [B, r, r, 3] f32, the four maps [B, r, r] and
    'polys' (each sample's polygons, a list)."""

    def __init__(self, resize=960):
        self.resize = resize

    def __call__(self, samples):
        n = len(samples)
        r = self.resize
        out = {
            "image": np.zeros((n, r, r, 3), np.float32),
            "probability_mask": np.zeros((n, r, r), np.float32),
            "probability_ignore_mask": np.zeros((n, r, r), np.float32),
            "threshold_mask": np.zeros((n, r, r), np.float32),
            "threshold_ignore_mask": np.zeros((n, r, r), np.float32),
        }
        all_polys = []
        for i, s in enumerate(samples):
            img = s["image"]
            h, w = img.shape[:2]
            out["image"][i, :h, :w] = img / 255.0
            for key in ("probability_mask", "probability_ignore_mask",
                        "threshold_mask", "threshold_ignore_mask"):
                out[key][i, :h, :w] = s[key]
            all_polys.append(s.get("annots", []))
        out["polys"] = all_polys
        return out


class FakeTextDetectionDataset:
    """Synthetic: 1 to 3 bright rectangles as 'text regions' on a dark
    image, drawn from ``np.random.RandomState(idx)``."""

    def __init__(self, num_samples=32, image_hw=160,
                 map_generator: Optional[DBNetMapGenerator] = None):
        self.num_samples = num_samples
        self.image_hw = image_hw
        self.map_generator = map_generator or DBNetMapGenerator()

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        hw = self.image_hw
        image = rng.uniform(0, 50, (hw, hw, 3)).astype(np.float32)
        polys = []
        for _ in range(rng.randint(1, 4)):
            w = rng.randint(hw // 4, hw // 2)
            h = rng.randint(hw // 10, hw // 5)
            x, y = rng.randint(0, hw - w), rng.randint(0, hw - h)
            image[y:y + h, x:x + w] = 230.0
            polys.append(np.array([[x, y], [x + w, y], [x + w, y + h],
                                   [x, y + h]], np.float32))
        sample = {"image": image, "annots": polys,
                  "ignore_flags": [False] * len(polys)}
        return self.map_generator(sample)


class DBNetDecoder:
    """Host-side decode: threshold the probability map, follow its contours
    (at most ``max_box_num``), score each by the mean probability inside
    it, call it curved text where its area is under
    ``rectangle_similarity`` of its rotated rectangle's (then simplify it
    by Douglas-Peucker), unclip it by D = A * ratio / L with round joins
    (``ops.polygon``), clip it to the image and keep the rotated
    rectangle's corners for line text or the grown polygon for curved
    text. The mean probability is summed over the contour's box (the JAX
    package sums the whole map: the same terms in another order)."""

    def __init__(self, use_morph_open=False, hard_border_threshold=None,
                 box_score_threshold=0.5, min_area_size=9,
                 max_box_num=1000, rectangle_similarity=0.6,
                 min_box_size=3, line_text_expand_ratio=1.2,
                 curve_text_expand_ratio=1.5):
        self.box_score_threshold = box_score_threshold
        self.min_area_size = min_area_size
        self.max_box_num = max_box_num
        self.min_box_size = min_box_size
        self.rectangle_similarity = rectangle_similarity
        self.line_text_expand_ratio = line_text_expand_ratio
        self.curve_text_expand_ratio = curve_text_expand_ratio
        self.prob_threshold = hard_border_threshold or 0.3

    def __call__(self, preds, sizes=None):
        """preds [B, H, W, 2] (a numpy array or a tensor on any device) ->
        per image (boxes, scores): ``boxes`` a list of [K, 2] f32 polygons
        (4 corners for line text, the grown polygon for curved text),
        ``scores`` [N] f32."""
        if isinstance(preds, torch.Tensor):
            preds = preds.detach().float().cpu().numpy()
        preds = np.asarray(preds)
        results = []
        for i in range(preds.shape[0]):
            prob = preds[i, :, :, 0]
            h, w = prob.shape
            binary = (prob > self.prob_threshold).astype(np.uint8)
            boxes, scores = [], []
            for cnt in find_contours(binary)[:self.max_box_num]:
                area = contour_area(cnt)
                if area < self.min_area_size:
                    continue
                pts = cnt.reshape(-1, 2)
                ys = slice(pts[:, 1].min(), pts[:, 1].max() + 1)
                xs = slice(pts[:, 0].min(), pts[:, 0].max() + 1)
                mask = fill_poly(
                    np.zeros((ys.stop - ys.start, xs.stop - xs.start),
                             np.uint8), pts - [xs.start, ys.start], 1)
                score = float((prob[ys, xs] * mask).sum()
                              / max(mask.sum(), 1))
                if score < self.box_score_threshold:
                    continue
                rect0 = min_area_rect(cnt)
                enclose_area = rect0[1][0] * rect0[1][1]
                if enclose_area < 1:
                    continue
                is_curve = area / enclose_area < self.rectangle_similarity
                poly = pts.astype(np.float32)
                if is_curve:
                    eps = 1e-3 * arc_length(cnt)
                    poly = approx_poly_dp(cnt, eps).reshape(-1, 2)
                if poly.shape[0] < 4:
                    continue
                ratio = (self.curve_text_expand_ratio if is_curve
                         else self.line_text_expand_ratio)
                d = unclip_distance(poly, ratio)
                grown = offset_polygon(poly, max(d, 1e-3))
                grown = clip_polygon_to_rect(grown, w, h)
                if grown.shape[0] < 4:
                    continue
                rect = min_area_rect(grown)
                if min(rect[1]) < self.min_box_size:
                    continue
                if is_curve:
                    boxes.append(grown.astype(np.float32))
                else:
                    boxes.append(box_points(rect).astype(np.float32))
                scores.append(score)
            results.append((boxes, np.asarray(scores, np.float32)))
        return results
