"""SAM matting (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/sam_matting.py``): a SAM
(or LightSAM) and the reference's fusion matting head on its
decoder-resolution outputs.

``FusionHead`` takes the mask logits [B, h, w, K] (h = S/4), the image
embedding [B, h/4, w/4, C] and the decoder's upscaled feature
[B, h, w, C/8]. Its global path reduces both features, resizes the
embedding's to h x w, concatenates the masks, and after two combining
convolutions upsamples twice by 2 (bilinear, the JAX ``resize_bilinear``)
to a 3-channel sigmoid trimap; its local path does the same with the
global path's reduced features concatenated in, to a 1-channel sigmoid
alpha. ``collaborative_matting`` fuses them by the trimap's argmax (the
first maximum).

``SAMMatting(multi_level=False)`` is the reference's sam_matting1: one head
over the four mask levels, predictions [B, H, W, c] and an IoU of
sigmoid(mean over the levels) [B, 1]. ``multi_level=True`` is sam_matting2:
one head per level (``fusion_pred_0`` ...), the predictions stacked on axis
1 ([B, 4, H, W, c]) and an IoU of sigmoid per level [B, 4].

The SAM takes point and box prompts only: as in the JAX tree, its prompt
encoder has no mask-prompt convolutions (``light_sam.drop_mask_prompt``).
The convolutions compute in ``dtype`` from f32 parameters, the sigmoids in
f32. NHWC; state-dict keys are the JAX paths (``fusion_pred.global_combine``)
after the SAM's own (``sam.image_encoder...``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.registry import MODELS
from ...ops.upsample import resize_bilinear
from ..common import Conv2d
from ..pfan import PFANMatting
from .light_sam import LightSAM, drop_mask_prompt
from .sam import sam_b, sam_l

__all__ = ["SAMMatting", "FusionHead", "collaborative_matting",
           "sam_b_matting1", "sam_l_matting1", "convformer_m36_sam_matting1",
           "sam_b_matting2", "sam_l_matting2", "convformer_m36_sam_matting2"]

collaborative_matting = PFANMatting.collaborative_matting


def _up2x(x):
    return resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))


class FusionHead(nn.Module):
    """(masks, image embedding, upscaled feature) -> (trimap
    [B, 4h, 4w, 3], alpha [B, 4h, 4w, 1]), f32 sigmoids."""

    def __init__(self, mask_planes: int, feat3_planes: int,
                 feat1_planes: int, planes: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        p = planes

        def conv(name, cin, cout):
            self.add_module(name, Conv2d(cin, cout, 3, padding=1,
                                         dtype=dtype))

        for side, extra in (("global", 0), ("local", 2 * p)):
            conv(f"{side}_feat3_reduce", feat3_planes, p)
            conv(f"{side}_feat1_reduce", feat1_planes, p)
            conv(f"{side}_combine", 2 * p + extra + mask_planes, 2 * p)
            conv(f"{side}_reduce", 2 * p, p)
            for i in (1, 2, 3):
                conv(f"{side}_up{i}", p, p)
        conv("global_pred", p, 3)
        conv("local_pred", p, 1)

    def _branch(self, side, x):
        relu = torch.relu
        x = relu(getattr(self, f"{side}_combine")(x))
        x = relu(getattr(self, f"{side}_reduce")(x))
        x = relu(getattr(self, f"{side}_up1")(_up2x(x)))
        x = relu(getattr(self, f"{side}_up2")(x))
        x = relu(getattr(self, f"{side}_up3")(_up2x(x)))
        return torch.sigmoid(getattr(self, f"{side}_pred")(x).float())

    def forward(self, masks, feat3, feat1):
        h, w = feat1.shape[1], feat1.shape[2]
        masks = masks.to(self.dtype)
        f3g = resize_bilinear(self.global_feat3_reduce(feat3), (h, w))
        f1g = torch.relu(self.global_feat1_reduce(feat1))
        global_pred = self._branch("global",
                                   torch.cat([f1g, f3g, masks], dim=-1))
        f3l = resize_bilinear(self.local_feat3_reduce(feat3), (h, w))
        f1l = torch.relu(self.local_feat1_reduce(feat1))
        local_pred = self._branch(
            "local", torch.cat([f1l, f3l, f1g, f3g, masks], dim=-1))
        return global_pred, local_pred


class SAMMatting(nn.Module):
    """(images [B, S, S, 3], prompts) -> (trimap, alpha, fused alpha, IoU);
    see the module's docstring for the shapes of each kind."""

    def __init__(self, sam: nn.Module, multi_level: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.sam = drop_mask_prompt(sam)
        self.multi_level = multi_level
        c = sam.prompt_encoder.embedding_planes
        levels = 4  # ``forward_matting``'s mask levels
        heads = ([("fusion_pred", levels)] if not multi_level else
                 [(f"fusion_pred_{i}", 1) for i in range(levels)])
        for name, mask_planes in heads:
            self.add_module(name, FusionHead(mask_planes, c, c // 8,
                                             dtype=dtype))
        self.levels = levels

    def forward(self, batch_images, batch_prompts,
                train: Optional[bool] = None):
        masks, ious, feat3, feat1 = self.sam.forward_matting(
            batch_images, batch_prompts, train)
        masks = masks.permute(0, 2, 3, 1)
        if not self.multi_level:
            g, l = self.fusion_pred(masks, feat3, feat1)
            iou = torch.sigmoid(ious.float().mean(dim=1, keepdim=True))
            return g, l, collaborative_matting(g, l), iou
        outs = [getattr(self, f"fusion_pred_{i}")(masks[..., i:i + 1], feat3,
                                                  feat1)
                for i in range(self.levels)]
        g = torch.stack([o[0] for o in outs], dim=1)
        l = torch.stack([o[1] for o in outs], dim=1)
        return g, l, collaborative_matting(g, l), torch.sigmoid(ious.float())


def _matting(make_sam, multi_level, kwargs):
    dtype = kwargs.get("dtype", torch.bfloat16)
    return SAMMatting(sam=make_sam(**kwargs), multi_level=multi_level,
                      dtype=dtype)


def _light(backbone_type):
    return lambda **kw: LightSAM(backbone_type=backbone_type, **kw)


@MODELS.register()
def sam_b_matting1(**kwargs):
    return _matting(sam_b, False, kwargs)


@MODELS.register()
def sam_l_matting1(**kwargs):
    return _matting(sam_l, False, kwargs)


@MODELS.register()
def sam_b_matting2(**kwargs):
    return _matting(sam_b, True, kwargs)


@MODELS.register()
def sam_l_matting2(**kwargs):
    return _matting(sam_l, True, kwargs)


@MODELS.register()
def convformer_m36_sam_matting1(**kwargs):
    return _matting(_light("convformer_m36"), False, kwargs)


@MODELS.register()
def convformer_m36_sam_matting2(**kwargs):
    return _matting(_light("convformer_m36"), True, kwargs)


def _register_light_sam_matting_variants():
    """The reference's eight light-SAM-matting backbones, each as matting1
    and matting2."""
    backbones = {
        "vanb0": "van_b0", "vanb1": "van_b1", "vanb2": "van_b2",
        "vanb3": "van_b3", "convformers18": "convformer_s18",
        "convformers36": "convformer_s36", "convformerm36": "convformer_m36",
        "convformerb36": "convformer_b36",
    }
    for short, bb in backbones.items():
        for suffix, multi in (("matting1", False), ("matting2", True)):
            MODELS.register(f"{short}_light_sam_{suffix}")(
                lambda _bb=bb, _ml=multi, **kw: _matting(_light(_bb), _ml,
                                                         kw))


_register_light_sam_matting_variants()
