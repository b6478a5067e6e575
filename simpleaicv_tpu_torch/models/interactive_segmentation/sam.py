"""SAM assembly and the sam_b / sam_l / sam_h factories (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/sam.py``), for inference.

The image encoder computes in ``dtype`` (bf16 by default); the prompt
encoder and mask decoder run in f32, as in the JAX package. The state_dict
keys are the reference SAM's names, so trained weights load by name.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...core.registry import MODELS
from ...ops.upsample import resize_bilinear
from .image_encoder import ViTImageEncoder
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder

__all__ = ["SAM", "sam_b", "sam_l", "sam_h"]


class SAM(nn.Module):
    def __init__(self, image_size: int = 1024, patch_size: int = 16,
                 image_encoder_embedding_planes: int = 768,
                 image_encoder_block_nums: int = 12,
                 image_encoder_head_nums: int = 12,
                 image_encoder_mlp_ratio: float = 4.0,
                 image_encoder_window_size: int = 14,
                 image_encoder_global_attn_indexes: Sequence[int] = (2, 5, 8,
                                                                     11),
                 prompt_encoder_embedding_planes: int = 256,
                 prompt_encoder_mask_inter_planes: int = 16,
                 mask_decoder_num_multimask_outputs: int = 3,
                 use_flash_attention: bool = True,
                 sigmoid_out: bool = False, binary_mask_out: bool = False,
                 mask_threshold: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.image_size = image_size
        self.sigmoid_out = sigmoid_out
        self.binary_mask_out = binary_mask_out
        self.mask_threshold = mask_threshold
        self.image_encoder = ViTImageEncoder(
            image_size=image_size, patch_size=patch_size,
            embedding_planes=image_encoder_embedding_planes,
            block_nums=image_encoder_block_nums,
            head_nums=image_encoder_head_nums,
            mlp_ratio=image_encoder_mlp_ratio,
            out_planes=prompt_encoder_embedding_planes,
            window_size=image_encoder_window_size,
            global_attn_indexes=tuple(image_encoder_global_attn_indexes),
            use_flash_attention=use_flash_attention, dtype=dtype)
        self.prompt_encoder = PromptEncoder(
            image_size=image_size, patch_size=patch_size,
            embedding_planes=prompt_encoder_embedding_planes,
            mask_inter_planes=prompt_encoder_mask_inter_planes)
        self.mask_decoder = MaskDecoder(
            inplanes=prompt_encoder_embedding_planes,
            num_multimask_outputs=mask_decoder_num_multimask_outputs)

    def forward(self, batch_images, batch_prompts: Dict[str, Optional[
            torch.Tensor]], mask_out_idxs: Sequence[int] = (0, 1, 2, 3)):
        """batch_images [B, S, S, 3]; batch_prompts holds ``prompt_point``
        [B, N, 3], ``prompt_box`` [B, 4] and ``prompt_mask`` [B, S/4, S/4, 1],
        each possibly None. Returns (masks [B, K, S, S], iou [B, K])."""
        image_embeddings = self.image_encoder(batch_images)
        sparse, dense = self.prompt_encoder(
            points=batch_prompts.get("prompt_point"),
            boxes=batch_prompts.get("prompt_box"),
            masks=batch_prompts.get("prompt_mask"))
        masks, iou_preds = self.mask_decoder(
            image_embeddings, self.prompt_encoder.get_dense_pe(), sparse,
            dense, mask_out_idxs=mask_out_idxs)
        masks = resize_bilinear(masks, (self.image_size, self.image_size),
                                spatial_axes=(2, 3))
        if self.sigmoid_out:
            masks = torch.sigmoid(masks)
        if self.binary_mask_out:
            masks = (masks > self.mask_threshold).float()
        return masks, iou_preds


def _sam(defaults, **kwargs):
    cfg = dict(defaults)
    cfg.update(kwargs)
    return SAM(**cfg)


@MODELS.register()
def sam_b(**kwargs):
    return _sam(dict(image_encoder_embedding_planes=768,
                     image_encoder_block_nums=12, image_encoder_head_nums=12,
                     image_encoder_global_attn_indexes=(2, 5, 8, 11)),
                **kwargs)


@MODELS.register()
def sam_l(**kwargs):
    return _sam(dict(image_encoder_embedding_planes=1024,
                     image_encoder_block_nums=24, image_encoder_head_nums=16,
                     image_encoder_global_attn_indexes=(5, 11, 17, 23)),
                **kwargs)


@MODELS.register()
def sam_h(**kwargs):
    return _sam(dict(image_encoder_embedding_planes=1280,
                     image_encoder_block_nums=32, image_encoder_head_nums=16,
                     image_encoder_global_attn_indexes=(7, 15, 23, 31)),
                **kwargs)
