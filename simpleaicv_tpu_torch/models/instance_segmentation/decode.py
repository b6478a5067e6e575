"""The SOLOv2 and YOLACT decoders and Gaussian Matrix NMS (counterpart of
``simpleaicv_tpu/models/instance_segmentation/decode.py``), fixed-shape and
on the predictions' device, returning numpy arrays padded with -1.

Every top-k here is ``topk_stable``: XLA's ``top_k`` returns tied entries
lowest index first, which ``torch.topk`` does not promise, so the port
sorts stably instead. The fill values (-1 for a dropped candidate) tie by
the hundred, and the choice among them decides which masks fill the
padding rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.registry import DECODERS
from ...ops.upsample import resize_bilinear
from .yolact import YOLACTAnchors

__all__ = ["SOLOV2Decoder", "YOLACTDecoder", "matrix_nms", "topk_stable"]


def topk_stable(x, k: int, dim: int = -1):
    """(values, indices) of the ``k`` largest entries of ``x`` along
    ``dim``, largest first and ties lowest index first (XLA's ``top_k``)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def matrix_nms(seg_masks, cate_labels, cate_scores, sigma: float = 2.0):
    """Gaussian Matrix NMS over [..., N, h, w] binary masks in descending
    score order; returns the decayed scores [..., N]."""
    n = seg_masks.shape[-3]
    flat = seg_masks.reshape(seg_masks.shape[:-2] + (-1,)).float()
    sum_masks = flat.sum(-1)
    inter = flat @ flat.transpose(-1, -2)
    union = sum_masks[..., :, None] + sum_masks[..., None, :] - inter
    iou = inter / union.clamp(min=1e-6)
    triu = torch.ones((n, n), dtype=torch.bool,
                      device=flat.device).triu(1)
    iou = torch.where(triu, iou, 0.0)
    label_match = (triu & (cate_labels[..., :, None]
                           == cate_labels[..., None, :])).float()
    decay_iou = iou * label_match
    compensate = decay_iou.amax(dim=-2)[..., :, None]
    decay = torch.exp(-sigma * decay_iou ** 2)
    comp = torch.exp(-sigma * compensate ** 2)
    coeff = (decay / comp).amin(dim=-2)
    return cate_scores * coeff


def _points_nms(heatmap):
    """Keeps the local peaks of [B, g, g, C] scores: a 2x2 max over a
    top-left pad of -1e9."""
    x = heatmap.permute(0, 3, 1, 2)
    pooled = F.max_pool2d(F.pad(x, (1, 0, 1, 0), value=-1e9), 2, 1)
    return heatmap * (pooled == x).permute(0, 2, 3, 1).to(heatmap.dtype)


def _gather_rows(x, index):
    """x [B, N, ...] at index [B, K] -> [B, K, ...]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], index]


@DECODERS.register()
class SOLOV2Decoder:
    """Per-level sigmoid and points NMS -> the ``candidate_pool`` best
    (cell, class) pairs above ``min_score_threshold`` (default 2 x topn) ->
    dynamic-convolution soft masks -> the stride filter (mask area above
    the cell's stride) -> maskness times score -> top ``topn`` -> Matrix
    NMS -> the update and keep thresholds -> top ``max_object_num`` -> the
    soft masks resized x4 (align corners) and thresholded."""

    def __init__(self, strides=(8, 8, 16, 32, 32),
                 grid_nums=(40, 36, 24, 16, 12),
                 mask_feature_upsample_scale=4, mask_threshold=0.5,
                 min_score_threshold=0.1, keep_score_threshold=0.1,
                 update_threshold=0.05, nms_sigma=2.0, topn=500,
                 max_object_num=100, candidate_pool=None,
                 keep_instance_threshold=None):
        self.strides = strides
        self.grid_nums = grid_nums
        self.upsample = mask_feature_upsample_scale
        self.mask_threshold = mask_threshold
        self.min_score_threshold = min_score_threshold
        self.update_threshold = (keep_instance_threshold
                                 if keep_instance_threshold is not None
                                 else update_threshold)
        self.keep_score_threshold = keep_score_threshold
        self.nms_sigma = nms_sigma
        self.topn = topn
        self.max_object_num = max_object_num
        self.candidate_pool = candidate_pool or 2 * topn

    @torch.no_grad()
    def __call__(self, preds):
        """preds: (mask features [B, h, w, C], kernels per level, category
        logits per level). Returns (masks [B, K, 4h, 4w] bool, labels
        [B, K], scores [B, K]) as numpy, padded with -1 (False)."""
        mask_feat, kernel_preds, cate_preds = preds
        b = mask_feat.shape[0]
        num_classes = cate_preds[0].shape[-1]
        device = mask_feat.device
        cates, kernels, strides = [], [], []
        for level, g in enumerate(self.grid_nums):
            cate = _points_nms(torch.sigmoid(cate_preds[level].float()))
            cates.append(cate.reshape(b, g * g, num_classes))
            kernels.append(kernel_preds[level].reshape(b, g * g, -1))
            strides.append(torch.full((g * g,), float(self.strides[level]),
                                      device=device))
        cate = torch.cat(cates, 1)
        kernels = torch.cat(kernels, 1)
        cell_strides = torch.cat(strides)

        p = cate.shape[1]
        pair_scores = cate.reshape(b, p * num_classes)
        pair_scores = torch.where(pair_scores > self.min_score_threshold,
                                  pair_scores, -1.0)
        pool = min(self.candidate_pool, p * num_classes)
        cand_scores, cand_idx = topk_stable(pair_scores, pool)
        cand_pos = cand_idx // num_classes
        cand_labels = cand_idx % num_classes
        cand_kernels = _gather_rows(kernels, cand_pos).float()
        valid = cand_scores > 0

        soft = torch.sigmoid(torch.einsum("bkc,bhwc->bkhw", cand_kernels,
                                          mask_feat.float()))
        binary = soft > self.mask_threshold
        mask_sum = binary.sum((2, 3)).float()
        valid = valid & (mask_sum > cell_strides[cand_pos])
        maskness = (soft * binary).sum((2, 3)) / mask_sum.clamp(min=1e-6)
        scores2 = torch.where(valid, cand_scores * maskness, -1.0)

        k = min(self.topn, pool)
        top_scores, top_i = topk_stable(scores2, k)
        top_labels = torch.gather(cand_labels, 1, top_i)
        top_soft = _gather_rows(soft, top_i)
        top_binary = _gather_rows(binary, top_i)
        del soft, binary

        keep_thr = max(self.update_threshold, self.keep_score_threshold)
        updated = matrix_nms(top_binary, top_labels, top_scores,
                             self.nms_sigma)
        updated = torch.where((updated >= keep_thr) & (top_scores > 0),
                              updated, -1.0)
        out_s, out_i = topk_stable(updated, self.max_object_num)
        ok = out_s > 0
        out_l = torch.where(ok, torch.gather(top_labels, 1, out_i), -1)
        chosen = _gather_rows(top_soft, out_i)
        up = resize_bilinear(chosen, (chosen.shape[2] * self.upsample,
                                      chosen.shape[3] * self.upsample),
                             spatial_axes=(2, 3), align_corners=True)
        out_m = (up > self.mask_threshold) & ok[:, :, None, None]
        return (out_m.cpu().numpy(), out_l.cpu().numpy(),
                torch.where(ok, out_s, -1.0).cpu().numpy())


@DECODERS.register()
class YOLACTDecoder:
    """Softmax class scores without the background, SSD-style box decode
    (variances 0.1 and 0.2) from the relative cxcywh anchors, fast NMS (per
    class the ``topn`` best anchors, kept when no better one of the class
    overlaps them by more than ``nms_threshold``, then the global
    ``max_object_num`` best) and each mask sigmoid(prototypes @
    coefficients) cropped to its padded box, at the prototypes' size."""

    def __init__(self, resize=544, resize_type="yolo_style",
                 scales=(24, 48, 96, 192, 384), ratios=(1, 0.5, 2),
                 strides=(8, 16, 32, 64, 128), topn=200, max_object_num=100,
                 min_score_threshold=0.05, nms_threshold=0.5):
        if resize_type == "retina_style":
            resize = int(round(resize * 1333.0 / 800))
        self.anchors = YOLACTAnchors(resize=resize, scales=scales,
                                     ratios=ratios, strides=strides)
        self.topn = topn
        self.max_object_num = max_object_num
        self.min_score_threshold = min_score_threshold
        self.nms_threshold = nms_threshold

    @torch.no_grad()
    def __call__(self, preds):
        """preds: the model's outputs (the semantic logits unused). Returns
        (masks [B, K, hp, wp] bool, labels [B, K], scores [B, K]) as numpy,
        padded with -1 (False)."""
        class_preds, box_preds, coef_preds, proto = preds[:4]
        sizes = [[c.shape[2], c.shape[1]] for c in class_preds]
        anchors = torch.from_numpy(self.anchors.flat_anchors(sizes)).to(
            proto.device)
        b = proto.shape[0]
        cls_flat = torch.cat([c.reshape(b, -1, c.shape[-1])
                              for c in class_preds], 1)
        box_p = torch.cat([x.reshape(b, -1, 4) for x in box_preds], 1)
        coef_p = torch.cat([x.reshape(b, -1, x.shape[-1])
                            for x in coef_preds], 1)

        probs = torch.softmax(cls_flat.float(), -1)[..., 1:]
        nc = probs.shape[-1]
        ctr = anchors[:, :2] + box_p[..., :2] * 0.1 * anchors[:, 2:]
        wh = anchors[:, 2:] * torch.exp(box_p[..., 2:] * 0.2)
        boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).clamp(0.0, 1.0)

        k = min(self.topn, probs.shape[1])
        scores_c, idx_c = topk_stable(probs.transpose(1, 2), k)  # [B, C, k]
        rows = torch.arange(b, device=proto.device)[:, None, None]
        boxes_c = boxes[rows, idx_c]                            # [B, C, k, 4]
        coefs_c = coef_p[rows, idx_c]                           # [B, C, k, P]
        lt = torch.maximum(boxes_c[:, :, :, None, :2],
                           boxes_c[:, :, None, :, :2])
        rb = torch.minimum(boxes_c[:, :, :, None, 2:],
                           boxes_c[:, :, None, :, 2:])
        whi = (rb - lt).clamp(min=0)
        inter = whi[..., 0] * whi[..., 1]
        area = (boxes_c[..., 2] - boxes_c[..., 0]).clamp(min=0) * \
            (boxes_c[..., 3] - boxes_c[..., 1]).clamp(min=0)
        union = (area[..., :, None] + area[..., None, :] - inter).clamp(
            min=1e-9)
        triu = torch.ones((k, k), dtype=torch.bool,
                          device=proto.device).triu(1)
        iou_max = torch.where(triu, inter / union, 0.0).amax(dim=-2)
        keep = (iou_max <= self.nms_threshold) & \
            (scores_c > self.min_score_threshold)
        flat_scores = torch.where(keep, scores_c, -1.0).reshape(b, -1)
        flat_labels = torch.arange(nc, device=proto.device)[:, None].expand(
            nc, k).reshape(-1)
        top_scores, top_idx = topk_stable(flat_scores, self.max_object_num)
        ok = top_scores > 0
        top_labels = torch.where(ok, flat_labels[top_idx], -1)
        top_boxes = _gather_rows(boxes_c.reshape(b, -1, 4), top_idx)
        top_coefs = _gather_rows(coefs_c.reshape(b, -1, coefs_c.shape[-1]),
                                 top_idx)

        mk = torch.sigmoid(torch.einsum("bhwp,bkp->bkhw", proto.float(),
                                        top_coefs.float()))
        hp, wp = mk.shape[2:]
        xs = torch.arange(wp, dtype=torch.float32,
                          device=proto.device)[None, None, None, :]
        ys = torch.arange(hp, dtype=torch.float32,
                          device=proto.device)[None, None, :, None]
        x1 = top_boxes[..., 0, None, None] * wp - 1
        x2 = top_boxes[..., 2, None, None] * wp + 1
        y1 = top_boxes[..., 1, None, None] * hp - 1
        y2 = top_boxes[..., 3, None, None] * hp + 1
        inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
        mk = ((mk * inside) > 0.5) & ok[..., None, None]
        return (mk.cpu().numpy(), top_labels.cpu().numpy(),
                torch.where(ok, top_scores, -1.0).cpu().numpy())
