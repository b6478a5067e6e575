"""SAM assembly and the sam_b / sam_l / sam_h factories (counterpart of
``simpleaicv_tpu/models/interactive_segmentation/sam.py``), for inference
and training.

The image encoder computes in ``dtype`` (bf16 by default); the prompt
encoder and mask decoder run in f32, as in the JAX package. The state_dict
keys are the reference SAM's names, so trained weights load by name.

Freezing: ``frozen_image_encoder`` and ``frozen_prompt_encoder`` cut the
gradient at the sub-module's outputs (``detach()`` where the JAX package
has ``stop_gradient``). ``frozen_mask_decoder`` is recorded only: gradients
must still flow through the decoder to what lies before it, so it is frozen
at the optimizer (``sub_layer_lr`` of 0 for ``mask_decoder``).
"""

from __future__ import annotations

import contextlib
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
                 use_gradient_checkpoint: bool = False,
                 use_flash_attention: bool = True,
                 frozen_image_encoder: bool = False,
                 frozen_prompt_encoder: bool = False,
                 frozen_mask_decoder: bool = False,
                 sigmoid_out: bool = False, binary_mask_out: bool = False,
                 mask_threshold: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.image_size = image_size
        self.frozen_image_encoder = frozen_image_encoder
        self.frozen_prompt_encoder = frozen_prompt_encoder
        self.frozen_mask_decoder = frozen_mask_decoder
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
            use_gradient_checkpoint=use_gradient_checkpoint,
            use_flash_attention=use_flash_attention, dtype=dtype)
        self.prompt_encoder = PromptEncoder(
            image_size=image_size, patch_size=patch_size,
            embedding_planes=prompt_encoder_embedding_planes,
            mask_inter_planes=prompt_encoder_mask_inter_planes)
        self.mask_decoder = MaskDecoder(
            inplanes=prompt_encoder_embedding_planes,
            num_multimask_outputs=mask_decoder_num_multimask_outputs)

    @contextlib.contextmanager
    def _mode(self, train):
        """``train`` is the JAX ``__call__``'s argument: True or False puts
        the module in that mode for this call only and the mode the caller
        set comes back afterwards; None leaves it alone. The mode decides
        only whether the encoder checkpoints its blocks, which is settled in
        the forward pass, so a later backward does not depend on it."""
        was = self.training
        if train is not None and train != was:
            self.train(train)
        try:
            yield
        finally:
            if self.training != was:
                self.train(was)

    def encode_image(self, images, train: Optional[bool] = None):
        """[B, S, S, 3] -> [B, S/16, S/16, C] f32 embeddings, cut from the
        graph when the image encoder is frozen."""
        with self._mode(train):
            emb = self.image_encoder(images)
        return emb.detach() if self.frozen_image_encoder else emb

    def _encode_prompts(self, batch_prompts):
        sparse, dense = self.prompt_encoder(
            points=batch_prompts.get("prompt_point"),
            boxes=batch_prompts.get("prompt_box"),
            masks=batch_prompts.get("prompt_mask"))
        if self.frozen_prompt_encoder:
            sparse, dense = sparse.detach(), dense.detach()
        return sparse, dense

    def forward(self, batch_images, batch_prompts: Dict[str, Optional[
            torch.Tensor]], mask_out_idxs: Sequence[int] = (0, 1, 2, 3),
            train: Optional[bool] = None):
        """batch_images [B, S, S, 3]; batch_prompts holds ``prompt_point``
        [B, N, 3], ``prompt_box`` [B, 4] and ``prompt_mask`` [B, S/4, S/4, 1],
        each possibly None. Returns (masks [B, K, S, S], iou [B, K])."""
        image_embeddings = self.encode_image(batch_images, train)
        sparse, dense = self._encode_prompts(batch_prompts)
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

    def forward_matting(self, batch_images, batch_prompts,
                        train: Optional[bool] = None):
        """Decoder-resolution forward for the matting fusion head: returns
        (masks [B, 4, S/4, S/4], iou [B, 4], the image embedding
        [B, S/16, S/16, C], the upscaled mask feature [B, S/4, S/4, C/8])."""
        image_embeddings = self.encode_image(batch_images, train)
        sparse, dense = self._encode_prompts(batch_prompts)
        masks, iou_preds, upscaled = self.mask_decoder(
            image_embeddings, self.prompt_encoder.get_dense_pe(), sparse,
            dense, mask_out_idxs=(0, 1, 2, 3), return_feats=True)
        return masks, iou_preds, image_embeddings, upscaled


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
