"""Mixup/CutMix batch collater (counterpart of
``simpleaicv_tpu/data/mixupcutmix.py``; timm-style): numpy end to end, NHWC
images, soft one-hot labels for ``OneHotLabelCELoss``. The partner is the
batch flipped; the draws come from the global ``np.random``, as in the JAX
package's collater, so the two give the same batch under one seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MixupCutmixClassificationCollater", "mixup_label"]


def one_hot(labels, num_classes, on_value, off_value):
    oh = np.full((labels.shape[0], num_classes), off_value, np.float32)
    oh[np.arange(labels.shape[0]), labels.astype(np.int64)] = on_value
    return oh


def mixup_label(labels, num_classes, lam, smoothing):
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = one_hot(labels, num_classes, on, off)
    y2 = one_hot(labels[::-1], num_classes, on, off)
    lam = np.asarray(lam, np.float32).reshape(-1, 1) if np.ndim(lam) else lam
    return y1 * lam + y2 * (1.0 - lam)


def rand_bbox(img_shape, lam, margin=0.0, count=None):
    """timm rand_bbox: cut ratio sqrt(1-lam), uniform center."""
    ratio = np.sqrt(1.0 - lam)
    h, w = img_shape[:2]
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    margin_y, margin_x = int(margin * cut_h), int(margin * cut_w)
    cy = np.random.randint(0 + margin_y, h - margin_y, size=count)
    cx = np.random.randint(0 + margin_x, w - margin_x, size=count)
    yl = np.clip(cy - cut_h // 2, 0, h)
    yh = np.clip(cy + cut_h // 2, 0, h)
    xl = np.clip(cx - cut_w // 2, 0, w)
    xh = np.clip(cx + cut_w // 2, 0, w)
    return yl, yh, xl, xh


class MixupCutmixClassificationCollater:

    def __init__(self, use_mixup=True, mixup_alpha=0.8, cutmix_alpha=1.0,
                 cutmix_minmax=None, mixup_cutmix_prob=1.0,
                 switch_to_cutmix_prob=0.5, mode="batch", correct_lam=True,
                 label_smoothing=0.1, num_classes=1000):
        assert mode in ("batch", "pair", "elem")
        self.use_mixup = use_mixup
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.cutmix_minmax = cutmix_minmax
        self.mixup_cutmix_prob = mixup_cutmix_prob
        self.switch_to_cutmix_prob = switch_to_cutmix_prob
        self.mode = mode
        self.correct_lam = correct_lam
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes

    def _params(self):
        lam = 1.0
        use_cutmix = False
        if np.random.rand() < self.mixup_cutmix_prob:
            if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
                use_cutmix = np.random.rand() < self.switch_to_cutmix_prob
                alpha = self.cutmix_alpha if use_cutmix else self.mixup_alpha
                lam = float(np.random.beta(alpha, alpha))
            elif self.mixup_alpha > 0.0:
                lam = float(np.random.beta(self.mixup_alpha, self.mixup_alpha))
            elif self.cutmix_alpha > 0.0:
                use_cutmix = True
                lam = float(np.random.beta(self.cutmix_alpha,
                                           self.cutmix_alpha))
        return lam, use_cutmix

    def __call__(self, samples):
        images = np.stack([s["image"] for s in samples]).astype(np.float32)
        labels = np.asarray([s["label"] for s in samples], np.int64)

        if not self.use_mixup:
            return {"image": images, "label": labels.astype(np.int32)}

        assert images.shape[0] % 2 == 0, "batch must be even for mixup"
        lam, use_cutmix = self._params()
        if lam != 1.0:
            flipped = images[::-1]
            if use_cutmix:
                yl, yh, xl, xh = rand_bbox(images.shape[1:3], lam)
                images[:, yl:yh, xl:xh] = flipped[:, yl:yh, xl:xh]
                if self.correct_lam:
                    h, w = images.shape[1:3]
                    lam = 1.0 - (yh - yl) * (xh - xl) / float(h * w)
            else:
                images = images * lam + flipped * (1.0 - lam)

        soft = mixup_label(labels, self.num_classes, lam, self.label_smoothing)
        return {"image": images.astype(np.float32), "label": soft}
