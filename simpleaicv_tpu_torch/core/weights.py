"""Moves parameters between the JAX package's trees and the port's modules.

``load_jax_params(model, params, batch_stats=None)`` takes
``variables["params"]`` of a JAX SAM, ViT, ViT-MoE, ResNet, DINO-DETR,
DETR, DeepLabV3+, PFAN, RetinaNet, FCOS, RetinaFace, Sapiens, MAE
pretraining, distillation (``KDModel``), LightSAM, SAM distillation, SAM
matting, SOLOv2, YOLACT, diffusion UNet, InceptionV3, DBNet or CTC model
(nested dicts of numpy arrays), a ConvFormer, VAN, DarkNet or CIFAR
ResNet, or a family model on one of them, and, for models with BatchNorm,
``variables["batch_stats"]``, and fills the port's model, or one of SAM's
sub-modules when called with that sub-module's sub-tree.
``export_jax_params(model)`` goes the other way: the model's parameters (or
any tensors keyed like them: gradients, optimizer moments, EMA) as a nested
dict of numpy arrays in the JAX tree's layout; ``export_jax_batch_stats``
gives the BatchNorm running statistics as the ``batch_stats`` tree.
SAM's, ViT's and Sapiens' backbone's state_dict keys are the reference
models' names; ``_RULES`` maps them onto the JAX package's parameter paths
(copies of the ``_REF_SAM_RULES`` and ``_MAE_VIT_RULES`` tables in
``simpleaicv_tpu/core/converters.py``); ViT-MoE's expert parameters
(``blocks.N.moe_mlp.{router, wi, bi, wo, bo}``) and the MAE model's
(``encoder_blocks.N``, ``decoder_blocks.N``, ``mask_token``,
``encoder_to_decoder``, ...) keep the JAX names and layouts, and a
``KDModel``'s or a SAM distillation model's ``teacher.`` and ``student.``
keys map to the ``teacher`` and ``student`` sub-trees by their networks'
rules, and a SAM matting model's ``sam.`` keys to its ``sam`` sub-tree.
The keys of ResNet, DINO-DETR, DETR, DeepLabV3+, PFAN, the dense detectors,
LightSAM's backbone and neck, Sapiens' head, SOLOv2,
YOLACT, the diffusion UNet and InceptionV3 are the JAX
paths with ``_N`` written ``.N`` (``layer1.0.conv1.conv``,
``encoder.0.self_attn.value_proj``, ``reg_head.1``,
``head.aspp2.aspp1.dw.conv``, ``clsregcnt_head.cls_gn.0``,
``sshs.2.conv7X7_1.bn``, ``convt3``). Layouts:
  * Dense kernel [in, out]  -> Linear weight [out, in];
  * Conv kernel HWIO        -> Conv2d weight OIHW (a depthwise kernel,
    I = 1, to [C, 1, kH, kW]);
  * ConvTranspose HWIO      -> ConvTranspose2d weight IOHW, spatially
    flipped (flax does not mirror the kernel, torch does);
  * LayerNorm, GroupNorm and BatchNorm (both kinds) ``scale`` ->
    ``weight``;
  * BatchNorm ``batch_stats`` ``mean``/``var`` -> buffers ``running_mean``/
    ``running_var``;
  * Embed ``embedding``     -> ``weight``;
  * flax ``OptimizedLSTMCell`` pairs ``<name>_fwd``/``<name>_bwd`` -> one
    bidirectional ``nn.LSTM`` ``<name>`` (``_lstm_leaves``);
  * plain parameters (pos_embed, rel_pos_h/w, embeddings, tokens) as they
    are.
Both directions raise on a leaf left over: a JAX leaf not consumed, a port
parameter not filled, a tensor with no parameter to go with.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.common import (BatchNorm, Conv2d, ConvTranspose2d, Embed,
                             GroupNorm, LayerNorm, Linear)
from ..models.interactive_segmentation.image_encoder import \
    LayerNormChannelsLast
from ..ops.fused_bn import FusedBatchNorm

__all__ = ["load_jax_params", "export_jax_params", "export_jax_batch_stats",
           "jax_paths", "path_form"]

# JAX leaves of the ``batch_stats`` collection carry this prefix in the
# flat tables below
BATCH_STATS = "batch_stats:"


def path_form(name: str) -> str:
    """A port name in the JAX tree's path form, ``_N`` for ``.N``:
    ``blocks.3.attn.qkv.weight`` -> ``blocks_3/attn/qkv/weight``. The
    optimizer's per-leaf table reads these names too."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", name).replace(".", "/")


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
    # ViT backbones
    (r"^(cls_token|position_encoding|patch_embedding|norm|fc)$", r"\1"),
    (r"^blocks\.(\d+)\.(norm\d)$", r"blocks_\1/\2"),
    (r"^blocks\.(\d+)\.attn\.(qkv|proj)$", r"blocks_\1/attn/\2"),
    (r"^blocks\.(\d+)\.mlp\.(fc\d)$", r"blocks_\1/mlp/\2"),
    # ViT-MoE's expert blocks: plain parameters in the JAX layouts
    (r"^blocks\.(\d+)\.moe_mlp\.(router|wi|bi|wo|bo)$",
     r"blocks_\1/moe_mlp/\2"),
    # the MAE pretraining model
    (r"^(mask_token|encoder_norm|encoder_to_decoder|decoder_norm|"
     r"decoder_pred)$", r"\1"),
    (r"^(encoder|decoder)_blocks\.(\d+)\.(norm\d)$", r"\1_blocks_\2/\3"),
    (r"^(encoder|decoder)_blocks\.(\d+)\.attn\.(qkv|proj)$",
     r"\1_blocks_\2/attn/\3"),
    (r"^(encoder|decoder)_blocks\.(\d+)\.mlp\.(fc\d)$",
     r"\1_blocks_\2/mlp/\3"),
    # the ConvFormer, VAN, DarkNet and CIFAR-ResNet backbones alone
    # (``downsample_layers.0.conv``, ``stages.2.5.norm1``,
    # ``patch_embed1.proj``, ``block1.0.layer_scale_1``, ``norm4``,
    # ``layer2.conv0.bn``): the JAX path itself
    (r"^(?:downsample_layers\.\d+|stages\.\d+\.\d+|patch_embed\d|"
     r"block\d\.\d+|norm\d|layer\d)(?:\..+)?$",
     lambda m: path_form(m.group(0))),
    # ResNet backbones (alone or as a detector's or segmenter's
    # ``backbone``), DINO-DETR, DETR, DeepLabV3+ (``head``), PFAN
    # (``decoder``, the matting branches, the prediction convolutions),
    # RetinaNet and FCOS (``fpn``, the heads, FCOS's ``scales``), RetinaFace
    # (``sshs``, ``cls_convs``, ``box_convs``), Sapiens' parsing head
    # (``convt1``, ``conv1``), LightSAM's ``fpn``, SAM matting's heads
    # (``fusion_pred``, ``fusion_pred_N``), SOLOv2 and YOLACT (``fpn``, the
    # heads, ``proto_net``), the diffusion UNet (``time_mlp_1``,
    # ``down_0``, ``down_2_conv``, ``middle_0``, ``up_3_conv``, ...),
    # InceptionV3 (torchvision's ``Conv2d_1a_3x3``, ``Mixed_5b``, ``fc``),
    # DBNet (``fpn``, ``head``) and the CTC model (``encoder``,
    # ``predictor``; a bare LSTM encoder's ``rnn1``, ``linear1``): the JAX
    # path itself
    (r"^(?:backbone\.)?(?:stem|layer\d\.\d+)(?:\..+)?$|"
     r"^(?:backbone|input_proj|input_proj_gn|level_embed|encoder|enc_output|"
     r"enc_output_norm|enc_out_class_embed|enc_out_bbox_embed|tgt_embed|"
     r"label_encoder|decoder|ref_point_head|decoder_norm|bbox_embed|"
     r"class_embed|proj_conv|query_embed|cls_head|reg_head|reg_head_out|"
     r"head|global_decoder|local_decoder|pred_conv|global_pred_conv|"
     r"local_pred_conv|fpn|clsregcnt_head|scales|sshs|cls_convs|box_convs|"
     r"convt\d+|conv\d+|fusion_pred(?:_\d+)?|mask_feature_head|bbox_head|"
     r"proto_net|semantic_seg_conv|time_mlp_\d|class_mlp_\d|predictor|"
     r"rnn\d|linear\d|"
     r"(?:down|up)_\d+(?:_conv)?|middle_\d+|last_norm|last_conv|"
     r"Conv2d_\w+|Mixed_\w+)"
     r"(?:\..+)?$", lambda m: path_form(m.group(0))),
    # a DCNv2 layer alone (``ops/dcnv2.py::DeformConv2d``): the JAX names
    (r"^(?:offset_mask_conv|kernel|bias)$", r"\g<0>"),
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
    # a distillation model's two networks and a matting model's SAM: each
    # its own tree
    kd = re.match(r"^(teacher|student|sam)\.(.+)$", full)
    if kd and not root:
        return f"{kd.group(1)}/{_jax_path(kd.group(2), '')}"
    for pattern, repl in _RULES:
        if re.match(pattern, full):
            path = re.sub(pattern, repl, full)
            return path[len(root.replace(".", "/")) + 1:] if root else path
    raise KeyError(f"no JAX parameter rule for port parameter '{full}'")


def _conv_t_to_port(a):
    return a[::-1, ::-1].transpose(2, 3, 0, 1)


def _conv_t_to_jax(a):
    return a.transpose(2, 3, 0, 1)[::-1, ::-1]


# (port leaf, JAX leaf, JAX -> port layout, port -> JAX layout) per layer
_LAYER_LEAVES = {
    Linear: [("weight", "kernel", np.transpose, np.transpose),
             ("bias", "bias", None, None)],
    Conv2d: [("weight", "kernel", lambda a: a.transpose(3, 2, 0, 1),
              lambda a: a.transpose(2, 3, 1, 0)),
             ("bias", "bias", None, None)],
    ConvTranspose2d: [("weight", "kernel", _conv_t_to_port, _conv_t_to_jax),
                      ("bias", "bias", None, None)],
    LayerNorm: [("weight", "scale", None, None), ("bias", "bias", None, None)],
    LayerNormChannelsLast: [("weight", "scale", None, None),
                            ("bias", "bias", None, None)],
    GroupNorm: [("weight", "scale", None, None), ("bias", "bias", None, None)],
    FusedBatchNorm: [("weight", "scale", None, None),
                     ("bias", "bias", None, None),
                     ("running_mean", BATCH_STATS + "mean", None, None),
                     ("running_var", BATCH_STATS + "var", None, None)],
    Embed: [("weight", "embedding", None, None)],
}
_LAYER_LEAVES[BatchNorm] = _LAYER_LEAVES[FusedBatchNorm]


def _lstm_leaves(name: str, module: nn.LSTM, root: str):
    """The groups of a one-layer ``nn.LSTM`` (bidirectional or not) against
    flax's ``OptimizedLSTMCell`` trees ``<path>_fwd`` and ``<path>_bwd``:
    flax keeps the input kernels ``ii/if/ig/io`` [in, H] without bias and
    the hidden kernels ``hi/hf/hg/ho`` [H, H] with bias, gates in torch's
    order (i, f, g, o). ``weight_ih_l0`` and ``weight_hh_l0`` [4H, .] are
    their transposed concatenations, ``bias_hh_l0`` flax's bias and
    ``bias_ih_l0`` zero; the export sums the two biases."""
    if module.num_layers != 1:
        raise ValueError(f"'{name}': only one-layer LSTMs map onto flax cells")
    path = _jax_path(name, root)
    prefix = f"{name}." if name else ""
    cells = (("", "fwd"), ("_reverse", "bwd"))[:2 if module.bidirectional
                                                 else 1]
    for sfx, cell in cells:
        base = f"{path}_{cell}"
        for kind in ("i", "h"):
            yield ((f"{prefix}weight_{kind}h_l0{sfx}",),
                   tuple(f"{base}/{kind}{g}/kernel" for g in _GATES),
                   lambda arrs: [np.concatenate(arrs, axis=1).T],
                   lambda arrs: list(np.split(arrs[0].T, 4, axis=1)))
        yield ((f"{prefix}bias_ih_l0{sfx}", f"{prefix}bias_hh_l0{sfx}"),
               tuple(f"{base}/h{g}/bias" for g in _GATES),
               lambda arrs: [np.zeros(4 * arrs[0].shape[0], np.float32),
                             np.concatenate(arrs)],
               lambda arrs: list(np.split(arrs[0] + arrs[1], 4)))


_GATES = "ifgo"


def _one(fn):
    """A one-leaf layout change as a group's: a list of one array."""
    return lambda arrs: [arrs[0] if fn is None else fn(arrs[0])]


def _leaves(model: nn.Module, root: str):
    """(state_dict keys, JAX leaf paths, JAX -> port layout, port -> JAX
    layout) for every parameter and buffer of ``model``, in groups: one
    key and one path, or an LSTM's gates (``_lstm_leaves``). The layouts
    take and give lists of arrays."""
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, nn.LSTM):
            yield from _lstm_leaves(name, module, root)
            continue
        leaves = _LAYER_LEAVES.get(type(module))
        if leaves is not None:
            path = _jax_path(name, root)
            for leaf, jax_leaf, to_port, to_jax in leaves:
                if getattr(module, leaf, None) is not None:
                    collection, _, jax_leaf = jax_leaf.rpartition(":")
                    full = f"{collection}:" if collection else ""
                    yield ((prefix + leaf,), (f"{full}{path}/{jax_leaf}",),
                           _one(to_port), _one(to_jax))
            continue
        own = list(module.named_parameters(recurse=False)) + list(
            module.named_buffers(recurse=False))
        for leaf, _ in own:
            yield ((prefix + leaf,), (_jax_path(prefix + leaf, root),),
                   _one(None), _one(None))


def jax_paths(model: nn.Module, root: str = "") -> Dict[str, str]:
    """state_dict key -> path of the same leaf in the JAX parameter tree
    (``batch_stats:`` and the path in the ``batch_stats`` tree for a
    BatchNorm's running statistics)."""
    return {key: "+".join(paths) for keys, paths, _, _ in _leaves(model, root)
            for key in keys}


def load_jax_params(model: nn.Module, params, root: str = "",
                    batch_stats=None) -> nn.Module:
    """Fills ``model`` from the JAX parameter tree ``params`` and, for a
    model with BatchNorm, the ``batch_stats`` tree.

    ``root`` is the model's own name inside a whole SAM (``""`` for SAM
    itself or a ViT backbone, ``"image_encoder"``, ``"prompt_encoder"`` or
    ``"mask_decoder"`` for a sub-module loaded from that sub-tree).
    """
    flat = _flatten(params)
    if batch_stats is not None:
        flat.update({BATCH_STATS + k: v
                     for k, v in _flatten(batch_stats).items()})
    state = model.state_dict()
    consumed, filled = set(), set()
    for keys, paths, to_port, _ in _leaves(model, root):
        for path, key in zip(paths, keys * len(paths)):
            if path not in flat:
                raise KeyError(f"JAX parameter '{path}' (for '{key}') "
                               f"missing")
        arrs = to_port([flat[path] for path in paths])
        for key, arr in zip(keys, arrs):
            target = state[key]
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"'{key}': JAX '{paths}' has shape "
                                 f"{arr.shape}, port expects "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(key)
        consumed.update(paths)

    unused = sorted(set(flat) - consumed)
    if unused:
        raise ValueError(f"JAX parameters not consumed: {unused}")
    unfilled = sorted(set(state) - filled)
    if unfilled:
        raise ValueError(f"port parameters not filled: {unfilled}")
    return model


def export_jax_batch_stats(model: nn.Module):
    """The JAX ``batch_stats`` tree (nested dicts of numpy arrays) of
    ``model``'s BatchNorm running statistics."""
    tree = {}
    state = model.state_dict()
    for keys, paths, _, _ in _leaves(model, ""):
        if paths[0].startswith(BATCH_STATS):
            _put(tree, paths[0][len(BATCH_STATS):],
                 state[keys[0]].detach().float().cpu().numpy())
    return tree


def _put(tree, path, arr):
    node = tree
    *parents, leaf = path.split("/")
    for part in parents:
        node = node.setdefault(part, {})
    node[leaf] = np.ascontiguousarray(arr)


def export_jax_params(model: nn.Module, tensors=None, root: str = ""):
    """The JAX parameter tree (nested dicts of numpy arrays) of ``model``.

    ``tensors`` maps state_dict keys to the tensors to export in the
    parameters' place (gradients, optimizer moments, EMA parameters); it
    defaults to ``model.state_dict()``. Raises if a parameter of ``model``
    has no tensor or a tensor has no key of ``model``. A buffer (SAM's
    ``positional_encoding_gaussian_matrix``, a parameter in the JAX tree) has
    no gradient and no moment: it is left out of the tree where ``tensors``
    does not hold it. BatchNorm running statistics belong to the
    ``batch_stats`` tree (``export_jax_batch_stats``), never to this one.
    """
    buffers = set()
    if tensors is None:
        tensors = model.state_dict()
    else:
        buffers = {name for name, _ in model.named_buffers()}
    tree, used = {}, set()
    for keys, paths, _, to_jax in _leaves(model, root):
        if paths[0].startswith(BATCH_STATS):
            used.update(keys)
            continue
        missing = [key for key in keys if key not in tensors]
        if missing:
            if all(key in buffers for key in missing):
                continue
            raise KeyError(f"no tensor for port parameter '{missing[0]}'")
        arrs = to_jax([tensors[key].detach().float().cpu().numpy()
                       for key in keys])
        for path, arr in zip(paths, arrs):
            _put(tree, path, arr)
        used.update(keys)
    extra = sorted(set(tensors) - used)
    if extra:
        raise ValueError(f"tensors with no port parameter: {extra}")
    return tree
