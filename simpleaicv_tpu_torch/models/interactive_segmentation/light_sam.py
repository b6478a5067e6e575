"""LightSAM and the SAM distillation models (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/light_sam.py``).

``LightSAM`` puts a backbone's C2-C5 features, fused by ``SAMFPN`` into one
stride-16 embedding, in place of SAM's ViT image encoder; its prompt
encoder, mask decoder and forwards are SAM's. The reference's ten
registered variants use VAN and ConvFormer backbones; any backbone with
``features_only`` and ``feature_channels`` serves
(``LightSAM(backbone_type="resnet18")``).

``SAMDistillModel`` runs a frozen teacher and a trainable student on the
same images and prompts; ``SAMDistillEncoderModel`` only their image
encoders. The teacher runs as the JAX model runs it, with ``train=False``
and no gradient (under ``torch.no_grad``). Its parameters stay in the
trained model, as in the JAX tree: unless ``frozen_layer_name_list`` names
``teacher``, weight decay acts on them with a zero gradient.

Flax makes a sub-module's parameters only when ``init`` calls it, and the
JAX CLIs initialise these models without a mask prompt. So the JAX
encoder-distillation tree holds the two image encoders and nothing else,
and the whole-SAM distillation's (and SAM matting's) prompt encoders have
no mask-prompt convolutions. The port's models drop the same parts
(``drop_mask_prompt``; ``SAMDistillEncoderModel`` drops its SAMs' prompt
encoders and mask decoders), which they never call, so that their
parameters, optimizer moments and updates are the JAX tree's: AdamW's
weight decay would otherwise shrink them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...core.registry import BACKBONES, MODELS
from ..common import Conv2d
from ..detection.fpn import _upsample_to
from .image_encoder import LayerNormChannelsLast
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder
from .sam import SAM

__all__ = ["LightSAM", "SAMFPN", "SAMDistillEncoderModel",
           "SAMDistillModel", "drop_mask_prompt"]


class SAMFPN(nn.Module):
    """(C2, C3, C4, C5) -> one [B, H/16, W/16, out_planes] f32 embedding:
    1x1 laterals without bias, each resized to C4's size (align-corners
    bilinear), summed, a 3x3 convolution without bias and the channel
    LayerNorm."""

    def __init__(self, in_channels: Sequence[int], out_planes: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv2d(c, out_planes, 1,
                                                   bias=False, dtype=dtype))
        self.fuse_conv = Conv2d(out_planes, out_planes, 3, padding=1,
                                bias=False, dtype=dtype)
        self.fuse_ln = LayerNormChannelsLast(out_planes)

    def forward(self, features):
        h, w = features[2].shape[1], features[2].shape[2]
        x = sum(_upsample_to(getattr(self, f"lateral_{i}")(c), h, w)
                for i, c in enumerate(features))
        return self.fuse_ln(self.fuse_conv(x))


class LightSAM(nn.Module):
    """SAM with a backbone and ``SAMFPN`` as its image encoder; the same
    call signatures, outputs and freezing options as ``SAM``."""

    def __init__(self, backbone_type: str = "convformer_m36",
                 image_size: int = 1024,
                 prompt_encoder_embedding_planes: int = 256,
                 mask_decoder_num_multimask_outputs: int = 3,
                 frozen_image_encoder: bool = False,
                 frozen_prompt_encoder: bool = False,
                 frozen_mask_decoder: bool = False,
                 sigmoid_out: bool = False, binary_mask_out: bool = False,
                 mask_threshold: float = 0.0,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.image_size = image_size
        self.frozen_image_encoder = frozen_image_encoder
        self.frozen_prompt_encoder = frozen_prompt_encoder
        self.frozen_mask_decoder = frozen_mask_decoder
        self.sigmoid_out = sigmoid_out
        self.binary_mask_out = binary_mask_out
        self.mask_threshold = mask_threshold
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.fpn = SAMFPN(self.backbone.feature_channels,
                          prompt_encoder_embedding_planes, dtype=dtype)
        self.prompt_encoder = PromptEncoder(
            image_size=image_size,
            embedding_planes=prompt_encoder_embedding_planes)
        self.mask_decoder = MaskDecoder(
            inplanes=prompt_encoder_embedding_planes,
            num_multimask_outputs=mask_decoder_num_multimask_outputs)

    _mode = SAM._mode
    _encode_prompts = SAM._encode_prompts
    forward = SAM.forward
    forward_matting = SAM.forward_matting

    def encode_image(self, images, train: Optional[bool] = None):
        """[B, S, S, 3] -> [B, S/16, S/16, C] f32 embeddings, cut from the
        graph when the image encoder is frozen."""
        with self._mode(train):
            emb = self.fpn(self.backbone(images))
        return emb.detach() if self.frozen_image_encoder else emb


def drop_mask_prompt(sam):
    """The SAM (or LightSAM) without its prompt encoder's mask-prompt
    convolutions: it then takes no ``prompt_mask``."""
    sam.prompt_encoder.mask_downscaling = None
    return sam


def _drop_prompt_parts(sam):
    """The SAM without its prompt encoder and mask decoder."""
    sam.prompt_encoder = None
    sam.mask_decoder = None
    return sam


class SAMDistillEncoderModel(nn.Module):
    """images -> (teacher embedding, student embedding) for the encoder
    MSE; holds the two SAMs' image encoders only (see the module's
    docstring)."""

    def __init__(self, teacher: nn.Module, student: nn.Module):
        super().__init__()
        self.teacher = _drop_prompt_parts(teacher)
        self.student = _drop_prompt_parts(student)

    def forward(self, images, train: Optional[bool] = None):
        with torch.no_grad():
            tea = self.teacher.encode_image(images, False)
        return tea, self.student.encode_image(images, train)


class SAMDistillModel(nn.Module):
    """(images, point and box prompts) -> ((teacher masks, teacher IoUs),
    (student masks, student IoUs)) for ``SAMDistillLoss``."""

    def __init__(self, teacher: nn.Module, student: nn.Module):
        super().__init__()
        self.teacher = drop_mask_prompt(teacher)
        self.student = drop_mask_prompt(student)

    def forward(self, batch_images, batch_prompts,
                mask_out_idxs: Sequence[int] = (0, 1, 2, 3),
                train: Optional[bool] = None):
        with torch.no_grad():
            tea = self.teacher(batch_images, batch_prompts, mask_out_idxs,
                               False)
        return tea, self.student(batch_images, batch_prompts, mask_out_idxs,
                                 train)


def _register_light_sam_variants():
    """The reference's LightSAM names and the JAX package's two
    aliases."""
    variants = {
        "vanb0_light_sam": "van_b0", "vanb1_light_sam": "van_b1",
        "vanb2_light_sam": "van_b2", "vanb3_light_sam": "van_b3",
        "convformers18_light_sam": "convformer_s18",
        "convformers36_light_sam": "convformer_s36",
        "convformerm36_light_sam": "convformer_m36",
        "convformerb36_light_sam": "convformer_b36",
        "convformer_m36_light_sam": "convformer_m36",
        "van_b3_light_sam": "van_b3",
    }
    for name, bb in variants.items():
        MODELS.register(name)(
            lambda backbone_type=bb, **kw: LightSAM(
                backbone_type=backbone_type, **kw))


_register_light_sam_variants()
