"""The PFAN family (counterpart of ``simpleaicv_tpu/models/pfan.py``):
salient-object detection (``PFANSegmentation``, a 1-channel sigmoid), face
and human parsing (``PFANParsing``, ``num_classes`` logits) and matting
(``PFANMatting``: a 3-channel trimap branch, a 1-channel alpha branch that
also sees the trimap branch's features, and their collaborative fusion).

One decoder serves all three: context-aware pyramid features (CPFE: a 1x1
and 3x3 convolutions dilated by 3, 5 and 7, without bias) on C3 and C4,
3x3 convolutions on C1 and C2, everything resized to C1's size
(align-corners bilinear) and fused, then two 2x2 stride-2 transposed
convolutions back to the input's size. ``ConvBnAct`` is the backbone's
(``ops.fused_bn``, as the JAX package's ``_BN_FUSED`` default has it);
``ConvTBnAct`` uses flax's ``nn.BatchNorm`` (``models.common.BatchNorm``).
Prediction convolutions run in f32. NHWC; state-dict keys are the JAX
paths (``decoder.high_level_cpfe_4.conv_dil_3``, ``pred_conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import BACKBONES, MODELS
from .common import BatchNorm, Conv2d, ConvBnAct, ConvTranspose2d, recomputing
from .detection.fpn import _upsample_to

__all__ = ["PFANSegmentation", "PFANMatting", "PFANParsing"]


class CPFE(nn.Module):
    """Context-aware pyramid feature extraction: 1x1 + dilated 3x3
    (3/5/7)."""

    def __init__(self, in_planes: int, planes: int = 32,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv_1_1 = Conv2d(in_planes, planes, 1, bias=False, dtype=dtype)
        for d in (3, 5, 7):
            self.add_module(f"conv_dil_{d}", Conv2d(
                in_planes, planes, 3, padding=d, bias=False, dtype=dtype,
                dilation=d))
        self.conv = ConvBnAct(4 * planes, planes, 3, dtype=dtype)

    def forward(self, x, train: bool = False):
        x = torch.cat([self.conv_1_1(x), self.conv_dil_3(x),
                       self.conv_dil_5(x), self.conv_dil_7(x)], dim=-1)
        return self.conv(x, train)


class ConvTBnAct(nn.Module):
    """2x2 stride-2 transposed convolution (no bias) -> flax BatchNorm in
    f32 -> ReLU in ``dtype``."""

    def __init__(self, in_planes: int, planes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.convt = ConvTranspose2d(in_planes, planes, 2, 2, bias=False,
                                     dtype=dtype)
        self.bn = BatchNorm(planes)
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        x = self.bn(self.convt(x), train, update_stats=not recomputing())
        return F.relu(x.to(self.dtype))


class _PFANDecoder(nn.Module):
    """(C1..C4) -> fused C1-size feature -> 4x upsample. With ``cross``
    (the matting alpha branch) the high-level feature is joined by the
    trimap branch's and the reduce convolution also sees the trimap
    branch's low-level feature: 4 x ``cpfe_planes`` inputs, not 2."""

    def __init__(self, in_channels, cpfe_planes: int = 32,
                 cross: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        p = cpfe_planes
        self.high_level_cpfe_4 = CPFE(in_channels[3], p, dtype)
        self.high_level_cpfe_3 = CPFE(in_channels[2], p, dtype)
        self.high_level_conv = ConvBnAct(2 * p, p, 1, has_act=False,
                                         dtype=dtype)
        self.low_level_conv_1 = ConvBnAct(in_channels[0], p, 3, dtype=dtype)
        self.low_level_conv_2 = ConvBnAct(in_channels[1], p, 3, dtype=dtype)
        self.low_level_conv = ConvBnAct(2 * p, p, 1, has_act=False,
                                        dtype=dtype)
        self.reduce_conv1 = ConvBnAct((4 if cross else 2) * p, p, 1,
                                      has_act=False, dtype=dtype)
        self.upsample_conv1 = ConvTBnAct(p, p, dtype)
        self.upsample_conv2 = ConvBnAct(p, p, 3, dtype=dtype)
        self.upsample_conv3 = ConvTBnAct(p, p, dtype)

    def forward(self, features, train: bool = False, cross=None):
        """(the decoded feature, {"conv_34", "conv_12"}: the high- and
        low-level features that a crossing branch reads)."""
        c1, c2, c3, c4 = features
        h1, w1 = c1.shape[1], c1.shape[2]
        f4 = self.high_level_cpfe_4(c4, train)
        f3 = self.high_level_cpfe_3(c3, train)
        f4 = _upsample_to(f4, c3.shape[1], c3.shape[2])
        high = self.high_level_conv(torch.cat([f3, f4], -1), train)
        high = _upsample_to(high, h1, w1)
        mid = {"conv_34": high}
        if cross is not None:
            high = torch.cat([high, cross["conv_34"]], -1)

        f1 = self.low_level_conv_1(c1, train)
        f2 = _upsample_to(self.low_level_conv_2(c2, train), h1, w1)
        low = self.low_level_conv(torch.cat([f1, f2], -1), train)
        mid["conv_12"] = low

        if cross is None:
            fused = torch.cat([low, high], -1)
        else:
            fused = torch.cat([low, cross["conv_12"], high], -1)
        x = self.reduce_conv1(fused, train)
        x = self.upsample_conv1(x, train)
        x = self.upsample_conv2(x, train)
        x = self.upsample_conv3(x, train)
        return x, mid


def _pred_conv(planes: int, out_planes: int):
    return Conv2d(planes, out_planes, 3, padding=1, bias=True,
                  dtype=torch.float32)


class _PFAN(nn.Module):

    def __init__(self, backbone_type: str, use_gradient_checkpoint: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)

    def _features(self, x, train):
        """(train, the backbone's four stages); ``train`` defaults to the
        module's mode."""
        if train is None:
            train = self.training
        return train, self.backbone(x, train)


class PFANSegmentation(_PFAN):
    """[B, H, W, 3] images -> [B, H, W, 1] f32 sigmoid probabilities."""

    def __init__(self, backbone_type: str, cpfe_planes: int = 32,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(backbone_type, use_gradient_checkpoint, dtype)
        self.decoder = _PFANDecoder(self.backbone.feature_channels,
                                    cpfe_planes, dtype=dtype)
        self.pred_conv = _pred_conv(cpfe_planes, 1)

    def forward(self, x, train: bool | None = None, generator=None):
        train, feats = self._features(x, train)
        x, _ = self.decoder(feats, train)
        return torch.sigmoid(self.pred_conv(x.float()))


class PFANParsing(_PFAN):
    """[B, H, W, 3] images -> [B, H, W, num_classes] f32 logits."""

    def __init__(self, backbone_type: str, num_classes: int = 19,
                 cpfe_planes: int = 32, use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(backbone_type, use_gradient_checkpoint, dtype)
        self.decoder = _PFANDecoder(self.backbone.feature_channels,
                                    cpfe_planes, dtype=dtype)
        self.pred_conv = _pred_conv(cpfe_planes, num_classes)

    def forward(self, x, train: bool | None = None, generator=None):
        train, feats = self._features(x, train)
        x, _ = self.decoder(feats, train)
        return self.pred_conv(x.float())


class PFANMatting(_PFAN):
    """[B, H, W, 3] images -> (trimap [B, H, W, 3], alpha [B, H, W, 1],
    fused alpha [B, H, W, 1]), f32 sigmoid probabilities."""

    def __init__(self, backbone_type: str, cpfe_planes: int = 32,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(backbone_type, use_gradient_checkpoint, dtype)
        ch = self.backbone.feature_channels
        self.global_decoder = _PFANDecoder(ch, cpfe_planes, dtype=dtype)
        self.local_decoder = _PFANDecoder(ch, cpfe_planes, cross=True,
                                          dtype=dtype)
        self.global_pred_conv = _pred_conv(cpfe_planes, 3)
        self.local_pred_conv = _pred_conv(cpfe_planes, 1)

    def forward(self, x, train: bool | None = None, generator=None):
        train, feats = self._features(x, train)
        g, g_mid = self.global_decoder(feats, train)
        loc, _ = self.local_decoder(feats, train, cross=g_mid)
        global_pred = torch.sigmoid(self.global_pred_conv(g.float()))
        local_pred = torch.sigmoid(self.local_pred_conv(loc.float()))
        fused = self.collaborative_matting(global_pred, local_pred)
        return global_pred, local_pred, fused

    @staticmethod
    def collaborative_matting(global_pred, local_pred):
        """The alpha where the trimap's argmax is 'unknown' (1), 1 where it
        is foreground (2), 0 on the background (0)."""
        max_idx = torch.argmax(global_pred, dim=-1, keepdim=True)
        trimap_mask = (max_idx == 1).to(local_pred.dtype)
        fg_mask = (max_idx == 2).to(local_pred.dtype)
        return local_pred * trimap_mask + fg_mask


def _register_pfan_variants():
    """``<backbone>_pfan_{segmentation,matting,face_parsing,
    human_parsing}`` for the ResNets, VAN-B0 to B3 (``vanb2``) and the
    four ConvFormers (``convformerm36``)."""
    backbones = {
        "resnet18": "resnet18", "resnet34": "resnet34",
        "resnet50": "resnet50", "resnet101": "resnet101",
        "resnet152": "resnet152",
        "vanb0": "van_b0", "vanb1": "van_b1", "vanb2": "van_b2",
        "vanb3": "van_b3",
        "convformers18": "convformer_s18", "convformers36": "convformer_s36",
        "convformerm36": "convformer_m36", "convformerb36": "convformer_b36",
    }
    for ref_name, bb in backbones.items():
        for task, cls in [("segmentation", PFANSegmentation),
                          ("matting", PFANMatting),
                          ("face_parsing", PFANParsing),
                          ("human_parsing", PFANParsing)]:

            def factory(backbone_type=bb, _cls=cls, **kwargs):
                kwargs.pop("backbone_pretrained_path", None)
                kwargs.pop("planes", None)
                return _cls(backbone_type=backbone_type, **kwargs)

            MODELS.register(f"{ref_name}_pfan_{task}")(factory)


_register_pfan_variants()
