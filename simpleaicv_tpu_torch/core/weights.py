"""Loads the JAX package's SAM parameters into the port's modules.

``load_jax_params(model, params)`` takes ``variables["params"]`` of the JAX
SAM (nested dicts of numpy arrays) and fills the port's SAM, or one of its
sub-modules when called with that sub-module's sub-tree. The port's
state_dict keys are the reference SAM's names; ``_RULES`` maps them onto the
JAX package's parameter paths (a copy of the ``_REF_SAM_RULES`` table in
``simpleaicv_tpu/core/converters.py``). Layouts:
  * Dense kernel [in, out]  -> Linear weight [out, in];
  * Conv kernel HWIO        -> Conv2d weight OIHW;
  * ConvTranspose HWIO      -> ConvTranspose2d weight IOHW, spatially
    flipped (flax does not mirror the kernel, torch does);
  * LayerNorm ``scale``     -> ``weight``;
  * plain parameters (pos_embed, rel_pos_h/w, embeddings, tokens) as they
    are.
Raises on any JAX leaf left unused and on any port parameter left unfilled.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.common import Conv2d, ConvTranspose2d, LayerNorm, Linear
from ..models.interactive_segmentation.image_encoder import \
    LayerNormChannelsLast

__all__ = ["load_jax_params"]

_RULES = [
    (r"^image_encoder\.pos_embed$", "image_encoder/pos_embed"),
    (r"^image_encoder\.patch_embed\.proj$", "image_encoder/patch_embed"),
    (r"^image_encoder\.blocks\.(\d+)\.(norm\d)$",
     r"image_encoder/blocks_\1/\2"),
    (r"^image_encoder\.blocks\.(\d+)\.attn\.(qkv|proj|rel_pos_[hw])$",
     r"image_encoder/blocks_\1/attn/\2"),
    (r"^image_encoder\.blocks\.(\d+)\.mlp\.lin(\d)$",
     r"image_encoder/blocks_\1/mlp_lin\2"),
    (r"^image_encoder\.neck\.0$", "image_encoder/neck_conv1"),
    (r"^image_encoder\.neck\.1$", "image_encoder/neck_ln1"),
    (r"^image_encoder\.neck\.2$", "image_encoder/neck_conv2"),
    (r"^image_encoder\.neck\.3$", "image_encoder/neck_ln2"),
    (r"^prompt_encoder\.pe_layer\.positional_encoding_gaussian_matrix$",
     "prompt_encoder/pe_layer/positional_encoding_gaussian_matrix"),
    (r"^prompt_encoder\.(point_embeddings|not_a_point_embed|no_mask_embed)$",
     r"prompt_encoder/\1"),
    (r"^prompt_encoder\.mask_downscaling\.0$", "prompt_encoder/mask_conv1"),
    (r"^prompt_encoder\.mask_downscaling\.1$", "prompt_encoder/mask_ln1"),
    (r"^prompt_encoder\.mask_downscaling\.3$", "prompt_encoder/mask_conv2"),
    (r"^prompt_encoder\.mask_downscaling\.4$", "prompt_encoder/mask_ln2"),
    (r"^prompt_encoder\.mask_downscaling\.6$", "prompt_encoder/mask_conv3"),
    (r"^mask_decoder\.(iou_token|mask_tokens)$", r"mask_decoder/\1"),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.(self_attn|"
     r"cross_attn_token_to_image|cross_attn_image_to_token)\.(\w+)$",
     r"mask_decoder/transformer/layers_\1/\2/\3"),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.(norm\d)$",
     r"mask_decoder/transformer/layers_\1/\2"),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.mlp\.lin(\d)$",
     r"mask_decoder/transformer/layers_\1/mlp/lin\2"),
    (r"^mask_decoder\.transformer\.final_attn_token_to_image\.(\w+)$",
     r"mask_decoder/transformer/final_attn_token_to_image/\1"),
    (r"^mask_decoder\.transformer\.norm_final_attn$",
     "mask_decoder/transformer/norm_final_attn"),
    (r"^mask_decoder\.output_upscaling\.0$", "mask_decoder/upscale_convt1"),
    (r"^mask_decoder\.output_upscaling\.1$", "mask_decoder/upscale_ln"),
    (r"^mask_decoder\.output_upscaling\.3$", "mask_decoder/upscale_convt2"),
    (r"^mask_decoder\.output_hypernetworks_mlps\.(\d+)\.layers\.(\d+)$",
     r"mask_decoder/output_hypernetworks_mlps_\1/layers_\2"),
    (r"^mask_decoder\.iou_prediction_head\.layers\.(\d+)$",
     r"mask_decoder/iou_prediction_head/layers_\1"),
]


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(val, "items"):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _jax_path(name: str, root: str) -> str:
    full = f"{root}.{name}" if root else name
    for pattern, repl in _RULES:
        if re.match(pattern, full):
            path = re.sub(pattern, repl, full)
            return path[len(root.replace(".", "/")) + 1:] if root else path
    raise KeyError(f"no JAX parameter rule for port parameter '{full}'")


# (port leaf, JAX leaf, layout change) per layer type
_LAYER_LEAVES = {
    Linear: [("weight", "kernel", lambda a: a.T), ("bias", "bias", None)],
    Conv2d: [("weight", "kernel", lambda a: a.transpose(3, 2, 0, 1)),
             ("bias", "bias", None)],
    ConvTranspose2d: [("weight", "kernel",
                       lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)),
                      ("bias", "bias", None)],
    LayerNorm: [("weight", "scale", None), ("bias", "bias", None)],
    LayerNormChannelsLast: [("weight", "scale", None), ("bias", "bias", None)],
}


def load_jax_params(model: nn.Module, params, root: str = "") -> nn.Module:
    """Fills ``model`` from the JAX parameter tree ``params``.

    ``root`` is the model's own name inside a whole SAM (``""`` for SAM
    itself, ``"image_encoder"``, ``"prompt_encoder"`` or ``"mask_decoder"``
    for a sub-module loaded from that sub-tree).
    """
    flat = _flatten(params)
    state = model.state_dict()
    consumed, filled = set(), set()

    def put(key, path, layout):
        if path not in flat:
            raise KeyError(f"JAX parameter '{path}' (for '{key}') missing")
        arr = flat[path]
        if layout is not None:
            arr = layout(arr)
        target = state[key]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"'{key}': JAX '{path}' has shape {arr.shape}, "
                             f"port expects {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
        consumed.add(path)
        filled.add(key)

    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        leaves = _LAYER_LEAVES.get(type(module))
        if leaves is not None:
            path = _jax_path(name, root)
            for leaf, jax_leaf, layout in leaves:
                if getattr(module, leaf, None) is not None:
                    put(prefix + leaf, f"{path}/{jax_leaf}", layout)
            continue
        own = list(module.named_parameters(recurse=False)) + list(
            module.named_buffers(recurse=False))
        for leaf, _ in own:
            put(prefix + leaf, _jax_path(prefix + leaf, root), None)

    unused = sorted(set(flat) - consumed)
    if unused:
        raise ValueError(f"JAX parameters not consumed: {unused}")
    unfilled = sorted(set(state) - filled)
    if unfilled:
        raise ValueError(f"port parameters not filled: {unfilled}")
    return model
