"""Official-weight converters (counterpart of
``simpleaicv_tpu/core/converters.py``): an official or a reference
PyTorch ``state_dict`` renamed onto the port's models.

``convert_official_state_dict(sd, family)`` renames each tensor by the
family's rules (``FAMILIES``: the JAX module's tables, copied) to the path
of the same leaf in the JAX package's tree (``layer1_0/conv1/conv/kernel``;
a BatchNorm's statistics ``batch_stats:<path>/mean``), and keeps its
PyTorch layout: the port's layers store torch's layouts, so no transpose
is made. ``apply_converted(model, converted)`` finds each leaf's name in
``model`` through the weight bridge (``core/weights.py::jax_paths``) and
loads what matches by name and shape through
``core/checkpoint.py::load_state_dict_partial`` (the position embedding
resized bicubically where its token count differs).

The port's parameter names follow the JAX tree (``stem.conv``,
``layer1.0.conv1.bn``, separate ``q``/``k``/``v`` projections, one
``point_embeddings`` tensor), not the reference's, so the families' merges
and splits stay: the prepasses (``FAMILY_PREPASS``: SAM's point
embeddings, DETR's and DINO-DETR's embeddings, VAN's layer scales) and the
split of a packed ``nn.MultiheadAttention`` projection into q, k and v.
A packed ``nn.LSTM`` keeps torch's gate layout: its gates are cut apart
here only to be placed by the bridge's paths and joined again by
``apply_converted``, with the two biases summed into ``bias_hh`` as the
port's cells hold them.

Families with real renaming: ``torchvision_resnet``, ``mae_vit``,
``dinov2_vit``, ``convformer``, ``inception_v3`` and ``sapiens_vit``; the
``ref_*`` families read the reference implementation's own names.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from .checkpoint import load_state_dict_partial
from .weights import BATCH_STATS, _leaves

__all__ = ["convert_official_state_dict", "apply_converted",
           "convert_torch_file", "FAMILIES"]


_RESNET_RULES = [
    (r"^conv1$", "stem/conv"),
    (r"^bn1$", "stem/bn"),
    (r"^layer(\d+)\.(\d+)\.conv(\d+)$", r"layer\1_\2/conv\3/conv"),
    (r"^layer(\d+)\.(\d+)\.bn(\d+)$", r"layer\1_\2/conv\3/bn"),
    (r"^layer(\d+)\.(\d+)\.downsample\.0$", r"layer\1_\2/downsample/conv"),
    (r"^layer(\d+)\.(\d+)\.downsample\.1$", r"layer\1_\2/downsample/bn"),
    (r"^fc$", "fc"),
]

_MAE_VIT_RULES = [
    (r"^cls_token$", "cls_token"),
    (r"^pos_embed$", "position_encoding"),
    (r"^patch_embed\.proj$", "patch_embedding"),
    (r"^blocks\.(\d+)\.(norm\d)$", r"blocks_\1/\2"),
    (r"^blocks\.(\d+)\.attn\.(qkv|proj)$", r"blocks_\1/attn/\2"),
    (r"^blocks\.(\d+)\.mlp\.(fc\d)$", r"blocks_\1/mlp/\2"),
    (r"^(fc_)?norm$", "norm"),
    # official MAE names the classifier ``head``; the reference's own ViT
    # (simpleAICV/classification/backbones/vit.py) names it ``fc``
    (r"^(head|fc)$", "fc"),
]

# the reference MAE PRETRAIN model (simpleAICV/masked_image_modeling/models/
# vit_mae.py:370-460): encoder./decoder. prefixed ViT blocks, an
# encoder_to_decoder linear and the decoder reconstruction head ``fc``.
# encoder.pos_embed / decoder.pos_embed are fixed sincos buffers — dropped
# (our model computes the identical tables; parity-verified in
# tests/test_reference_parity.py::test_mae_pretrain_parity).
_REF_MAE_PRETRAIN_RULES = [
    (r"^encoder\.cls_token$", "cls_token"),
    (r"^encoder\.patch_embed\.proj$", "patch_embedding"),
    (r"^encoder\.blocks\.(\d+)\.(norm\d)$", r"encoder_blocks_\1/\2"),
    (r"^encoder\.blocks\.(\d+)\.attn\.(qkv|proj)$",
     r"encoder_blocks_\1/attn/\2"),
    (r"^encoder\.blocks\.(\d+)\.mlp\.(fc\d)$", r"encoder_blocks_\1/mlp/\2"),
    (r"^encoder\.norm$", "encoder_norm"),
    (r"^encoder_to_decoder$", "encoder_to_decoder"),
    (r"^decoder\.mask_token$", "mask_token"),
    (r"^decoder\.blocks\.(\d+)\.(norm\d)$", r"decoder_blocks_\1/\2"),
    (r"^decoder\.blocks\.(\d+)\.attn\.(qkv|proj)$",
     r"decoder_blocks_\1/attn/\2"),
    (r"^decoder\.blocks\.(\d+)\.mlp\.(fc\d)$", r"decoder_blocks_\1/mlp/\2"),
    (r"^decoder\.norm$", "decoder_norm"),
    (r"^decoder\.fc$", "decoder_pred"),
]

# official DINOv2 checkpoints (dinov2_vitX14[_reg4]_pretrain.pth): the
# shared trunk uses the same timm naming as MAE (cls_token / pos_embed /
# patch_embed.proj / blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,fc2} /
# norm). DINOv2-only tensors — mask_token, register_tokens, blocks.N.ls1/
# ls2 layer-scale gammas — have no counterpart in the ViT and are dropped,
# which is exactly the reference converter's key-intersection semantics
# (classification/weight_convert/convert_vit_dinov2_weight_from_official_
# dinov2_pretrain_weight.py:45-50: copy only keys present in its ViT).
# pos_embed size mismatches (518/14 grid vs the recipe's input) resolve in
# load_state_dict_partial's bicubic pos-embed resize.
_DINOV2_VIT_RULES = [
    (r"^cls_token$", "cls_token"),
    (r"^pos_embed$", "position_encoding"),
    (r"^patch_embed\.proj$", "patch_embedding"),
    (r"^blocks\.(\d+)\.(norm\d)$", r"blocks_\1/\2"),
    (r"^blocks\.(\d+)\.attn\.(qkv|proj)$", r"blocks_\1/attn/\2"),
    (r"^blocks\.(\d+)\.mlp\.(fc\d)$", r"blocks_\1/mlp/\2"),
    (r"^norm$", "norm"),
]

_CONVFORMER_RULES = [
    (r"^downsample_layers\.(\d+)\.(conv|pre_norm|post_norm)$",
     r"downsample_layers_\1/\2"),
    (r"^stages\.(\d+)\.(\d+)\.token_mixer\.(dwconv|pwconv\d)$",
     r"stages_\1_\2/token_mixer/\3"),
    (r"^stages\.(\d+)\.(\d+)\.(norm\d)$", r"stages_\1_\2/\3"),
    (r"^stages\.(\d+)\.(\d+)\.mlp\.(fc\d)$", r"stages_\1_\2/mlp/\3"),
    (r"^(norm_head|norm)$", "norm"),
    (r"^head(\.fc\d)?$", "head"),
]

_INCEPTION_RULES = [
    (r"^(.*)$", lambda m: m.group(1).replace(".", "/")),
]

# sapiens (mmpretrain ViT): layers.N.{ln1,ln2}, attn.qkv/proj, ffn.layers.0.0
# / ffn.layers.1 linears; patch_embed.projection; pos_embed (no cls token)
_SAPIENS_RULES = [
    (r"^(backbone\.)?cls_token$", "cls_token"),
    (r"^(backbone\.)?pos_embed$", "position_encoding"),
    (r"^(backbone\.)?patch_embed\.projection$", "patch_embedding"),
    (r"^(backbone\.)?layers\.(\d+)\.ln1$", r"blocks_\2/norm1"),
    (r"^(backbone\.)?layers\.(\d+)\.ln2$", r"blocks_\2/norm2"),
    (r"^(backbone\.)?layers\.(\d+)\.attn\.(qkv|proj)$", r"blocks_\2/attn/\3"),
    (r"^(backbone\.)?layers\.(\d+)\.ffn\.layers\.0\.0$", r"blocks_\2/mlp/fc1"),
    (r"^(backbone\.)?layers\.(\d+)\.ffn\.layers\.1$", r"blocks_\2/mlp/fc2"),
    (r"^(backbone\.)?ln1$", "norm"),
    (r"^head$", "fc"),
]

# the reference sapiens parsing models (face_parsing/models/
# sapiens_face_parsing.py, human_parsing/models/sapiens_human_parsing.py):
# ViTBackbone under ``backbone.`` + VitHead under ``head.`` whose Sequentials
# interleave ConvTranspose/Conv (indices 0,3,6,9) with parameter-free
# InstanceNorm + SiLU.
_REF_SAPIENS_RULES = [
    (r"^backbone\.pos_embed$", "position_encoding"),
    (r"^backbone\.patch_embed\.proj$", "patch_embedding"),
    (r"^backbone\.blocks\.(\d+)\.(norm\d)$", r"blocks_\1/\2"),
    (r"^backbone\.blocks\.(\d+)\.attn\.(qkv|proj)$", r"blocks_\1/attn/\2"),
    (r"^backbone\.blocks\.(\d+)\.mlp\.(fc\d)$", r"blocks_\1/mlp/\2"),
    (r"^head\.deconv_layers\.(\d+)$",
     lambda m: f"convt{int(m.group(1)) // 3 + 1}"),
    (r"^head\.conv_layers\.(\d+)$",
     lambda m: f"conv{int(m.group(1)) // 3 + 1}"),
    (r"^head\.pred_conv$", "pred_conv"),
]

# The reference's OWN ResNet naming (simpleAICV/classification/backbones/
# resnet.py): every conv/bn pair lives in a ConvBnActBlock whose Sequential is
# named ``layer`` (layer.0 = conv, layer.1 = bn).  Used by the cross-framework
# parity tests, which convert real reference state_dicts.  The same trunk
# recurs (under a ``backbone.`` prefix, fc-less) in every reference detection/
# segmentation/OCR model, hence the prefixable helper.


def _ref_resnet_rules(src: str = "", dst: str = "", with_fc: bool = True):
    s, d = re.escape(src), dst
    rules = [
        (rf"^{s}conv1\.layer\.0$", f"{d}stem/conv"),
        (rf"^{s}conv1\.layer\.1$", f"{d}stem/bn"),
        (rf"^{s}layer(\d+)\.(\d+)\.conv(\d+)\.layer\.0$",
         rf"{d}layer\1_\2/conv\3/conv"),
        (rf"^{s}layer(\d+)\.(\d+)\.conv(\d+)\.layer\.1$",
         rf"{d}layer\1_\2/conv\3/bn"),
        (rf"^{s}layer(\d+)\.(\d+)\.downsample_conv\.layer\.0$",
         rf"{d}layer\1_\2/downsample/conv"),
        (rf"^{s}layer(\d+)\.(\d+)\.downsample_conv\.layer\.1$",
         rf"{d}layer\1_\2/downsample/bn"),
    ]
    if with_fc:
        rules.append((rf"^{s}fc$", f"{d}fc"))
    return rules


_REF_RESNET_RULES = _ref_resnet_rules()


def _gn_tower(m):
    """FCOS tower Sequential index -> our name: [conv, GN, relu]*4 so index
    3k = conv -> {cls,reg}_head_k, 3k+1 = GN -> {cls,reg}_gn_k."""
    prefix, idx = m.group(1), int(m.group(2))
    kind = "head" if idx % 3 == 0 else "gn"
    return f"clsregcnt_head/{prefix}_{kind}_{idx // 3}"


# RetinaNet (simpleAICV/detection/models/retinanet.py:27-140): towers are
# Sequential [conv, relu]*4 so index 2k = conv.
_REF_RETINANET_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^fpn\.(P\d_\d|P6)$", r"fpn/\1"),
    (r"^fpn\.P7\.1$", "fpn/P7"),
    (r"^(cls|reg)_head\.\1_head\.(\d+)$",
     lambda m: f"{m.group(1)}_head/{m.group(1)}_head_{int(m.group(2)) // 2}"),
    (r"^(cls|reg)_head\.\1_out$", r"\1_head/\1_out"),
]

# FCOS (simpleAICV/detection/models/fcos.py:27-92): resnet trunk + RetinaFPN
# (P7 = Sequential(relu, conv) -> index 1) + GN tower head + per-level scales.
_REF_FCOS_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^fpn\.(P\d_\d|P6)$", r"fpn/\1"),
    (r"^fpn\.P7\.1$", "fpn/P7"),
    (r"^clsregcnt_head\.(cls|reg)_head\.(\d+)$", _gn_tower),
    (r"^clsregcnt_head\.(cls_out|reg_out|center_out)$", r"clsregcnt_head/\1"),
    (r"^scales$", "scales"),
]

def _cb(idx: str) -> str:
    """ConvBnActBlock Sequential index -> our submodule name."""
    return "conv" if idx == "0" else "bn"


def _dwpw(idx: str) -> str:
    """LightConvBlock layers index -> our submodule name (0=dw, 1=pw)."""
    return "dw" if idx == "0" else "pw"


# DeepLabV3+ (simpleAICV/semantic_segmentation/models/deeplabv3plus.py:99-232):
# per-stage ASPP heads; LightConvBlock = Sequential(dw ConvBnAct, pw
# ConvBnAct); pooling = Sequential(AdaptiveAvgPool, ConvBnAct).
_REF_DEEPLAB_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^head\.aspp(\d)\.aspp0\.layer\.([01])$",
     lambda m: f"head/aspp{m.group(1)}/aspp0/{_cb(m.group(2))}"),
    (r"^head\.aspp(\d)\.aspp(\d)\.layers\.([01])\.layer\.([01])$",
     lambda m: (f"head/aspp{m.group(1)}/aspp{m.group(2)}/"
                f"{_dwpw(m.group(3))}/{_cb(m.group(4))}")),
    (r"^head\.aspp(\d)\.pooling\.1\.layer\.([01])$",
     lambda m: f"head/aspp{m.group(1)}/pooling_conv/{_cb(m.group(2))}"),
    (r"^head\.aspp(\d)\.fuse_conv\.layer\.([01])$",
     lambda m: f"head/aspp{m.group(1)}/fuse_conv/{_cb(m.group(2))}"),
    (r"^head\.fuse_conv\.([01])\.layers\.([01])\.layer\.([01])$",
     lambda m: (f"head/fuse_conv_{m.group(1)}/{_dwpw(m.group(2))}/"
                f"{_cb(m.group(3))}")),
    (r"^head\.predict_conv$", "head/predict_conv"),
]

def _pfan_decoder_rules(src: str, dst: str):
    """PFAN decoder block (salient_object_detection/models/
    pfan_segmentation.py:155-262; human_matting/models/pfan_matting.py uses
    the same modules under global_/local_ prefixes).  upsample_conv1/3 are
    ConvTransposeBnActBlocks -> our ``convt`` (torch's layout, which the
    port's ``ConvTranspose2d`` keeps)."""
    s = re.escape(src)
    return [
        (rf"^{s}(high_level_cpfe_[34])\.(conv_1_1|conv_dil_\d)$",
         lambda m, d=dst: f"{d}{m.group(1)}/{m.group(2)}"),
        (rf"^{s}(high_level_cpfe_[34])\.conv\.layer\.([01])$",
         lambda m, d=dst: f"{d}{m.group(1)}/conv/{_cb(m.group(2))}"),
        (rf"^{s}(high_level_conv|low_level_conv(?:_\d)?|reduce_conv1|"
         rf"upsample_conv2)\.layer\.([01])$",
         lambda m, d=dst: f"{d}{m.group(1)}/{_cb(m.group(2))}"),
        (rf"^{s}(upsample_conv[13])\.layer\.([01])$",
         lambda m, d=dst: (f"{d}{m.group(1)}/"
                           + ("convt" if m.group(2) == "0" else "bn"))),
    ]


_REF_PFAN_SEG_RULES = (
    _ref_resnet_rules("backbone.", "backbone/", False)
    + _pfan_decoder_rules("", "decoder/")
    + [(r"^pred_conv$", "pred_conv")])

_REF_PFAN_MATTING_RULES = (
    _ref_resnet_rules("backbone.", "backbone/", False)
    + _pfan_decoder_rules("global_", "global_decoder/")
    + _pfan_decoder_rules("local_", "local_decoder/")
    + [(r"^(global|local)_pred_conv$", r"\1_pred_conv")])

# DBNet (simpleAICV/text_detection/models/dbnet.py + fpn.py:48 + head.py:77):
# binary/thresh heads are Sequential(ConvBnAct, ConvTransposeBnAct,
# ConvTranspose2d) -> our conv / convt1+bn1 / convt2.
_REF_DBNET_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^fpn\.((?:c|p)\d_conv|last_conv)\.layer\.([01])$",
     lambda m: f"fpn/{m.group(1)}/{_cb(m.group(2))}"),
    (r"^head\.(binary|thresh)_conv\.0\.layer\.([01])$",
     lambda m: f"head/{m.group(1)}_conv/conv/{_cb(m.group(2))}"),
    (r"^head\.(binary|thresh)_conv\.1\.layer\.0$", r"head/\1_conv/convt1"),
    (r"^head\.(binary|thresh)_conv\.1\.layer\.1$", r"head/\1_conv/bn1"),
    (r"^head\.(binary|thresh)_conv\.2$", r"head/\1_conv/convt2"),
]

# CTC text recognition (simpleAICV/text_recognition/models/ctc_model.py:23 +
# encoder.py:18 BiLSTMEncoder rnn1/linear1/rnn2/linear2 + predictor.py:17).
_REF_CTC_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^encoder\.rnn(\d)\.__lstm_(fwd|bwd)__\.(\w+)\.(kernel|hbias)$",
     lambda m: (f"encoder/rnn{m.group(1)}_{m.group(2)}/{m.group(3)}/"
                + ("bias" if m.group(4) == "hbias" else "kernel"))),
    (r"^encoder\.linear(\d)$", r"encoder/linear\1"),
    (r"^predictor\.linear1$", "predictor/fc1"),
    (r"^predictor\.linear2$", "predictor/fc2"),
]

# RetinaFace (simpleAICV/face_detection/models/retinaface.py:27 + fpn.py:47):
# 3-level merge FPN + SSH context modules (note the reference's own
# conv7x7_3 lowercase-x key); our SSH names the 7x7 branch _1/_2.
_REF_RETINAFACE_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^fpn\.(output\d|merge\d)\.layer\.([01])$",
     lambda m: f"fpn/{m.group(1)}/{_cb(m.group(2))}"),
    (r"^ssh(\d)\.(conv3X3|conv5X5_1|conv5X5_2)\.layer\.([01])$",
     lambda m: (f"sshs_{int(m.group(1)) - 1}/{m.group(2)}/"
                f"{_cb(m.group(3))}")),
    (r"^ssh(\d)\.conv7X7_2\.layer\.([01])$",
     lambda m: f"sshs_{int(m.group(1)) - 1}/conv7X7_1/{_cb(m.group(2))}"),
    (r"^ssh(\d)\.conv7x7_3\.layer\.([01])$",
     lambda m: f"sshs_{int(m.group(1)) - 1}/conv7X7_2/{_cb(m.group(2))}"),
    (r"^cls_head_list\.(\d)\.conv1x1$", r"cls_convs_\1"),
    (r"^box_head_list\.(\d)\.conv1x1$", r"box_convs_\1"),
]

# Diffusion UNet (simpleAICV/diffusion_model/models/diffusion_unet.py:17-460):
# flat ModuleLists interleaving ResBlocks and Up/DownSampleBlocks; our names
# down_{i}/up_{i}/middle_{i} use the same flat indices, samplers are
# down_{i}_conv / up_{i}_conv.
_UNET_RES_SUB = {
    "block1.0": "norm1", "block1.2": "conv1",
    "time_embedding_proj.1": "time_proj",
    "class_embedding_proj.1": "class_proj",
    "block2.0": "norm2", "block2.3": "conv2",
    "nin_shortcut": "nin_shortcut", "conv_shortcut": "conv_shortcut",
    "attention.norm": "attention/norm", "attention.q": "attention/q",
    "attention.k": "attention/k", "attention.v": "attention/v",
    "attention.proj_out": "attention/proj_out",
}


def _unet_res(group: str):
    def repl(m):
        sub = _UNET_RES_SUB.get(m.group(2))
        return f"{group}_{m.group(1)}/{sub}" if sub else None
    return repl


_REF_DIFFUSION_UNET_RULES = [
    (r"^time_mlp\.1$", "time_mlp_1"),
    (r"^time_mlp\.3$", "time_mlp_2"),
    (r"^class_mlp\.0$", "class_embed"),
    (r"^class_mlp\.1$", "class_mlp_1"),
    (r"^class_mlp\.3$", "class_mlp_2"),
    (r"^stem$", "stem"),
    (r"^last_norm$", "last_norm"),
    (r"^last_conv$", "last_conv"),
    (r"^downsample_blocks\.(\d+)\.layer$", r"down_\1_conv"),
    (r"^upsample_blocks\.(\d+)\.layer$", r"up_\1_conv"),
    (r"^downsample_blocks\.(\d+)\.(.+)$", _unet_res("down")),
    (r"^middle_blocks\.(\d+)\.(.+)$", _unet_res("middle")),
    (r"^upsample_blocks\.(\d+)\.(.+)$", _unet_res("up")),
]

def _sam_prepass(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """SAM-specific: merge the four single-row point_embeddings into one
    (4,256) param and strip the ``.weight`` from 1-row nn.Embedding params so
    they convert as whole tensors (our params are plain arrays)."""
    out = {}
    points = {}
    for k, arr in sd.items():
        m = re.match(r"^prompt_encoder\.point_embeddings\.(\d)\.weight$", k)
        if m:
            points[int(m.group(1))] = np.asarray(arr)
            continue
        m = re.match(r"^prompt_encoder\.(not_a_point_embed|no_mask_embed)"
                     r"\.weight$", k)
        if m:
            out[f"prompt_encoder.{m.group(1)}"] = np.asarray(arr).reshape(-1)
            continue
        m = re.match(r"^mask_decoder\.(iou_token|mask_tokens)\.weight$", k)
        if m:
            out[f"mask_decoder.{m.group(1)}"] = np.asarray(arr)
            continue
        out[k] = arr
    if points:
        out["prompt_encoder.point_embeddings"] = np.concatenate(
            [points[i] for i in sorted(points)], axis=0)
    return out


# SAM (simpleAICV/interactive_segmentation/models/segment_anything/): ViT-det
# image encoder with decomposed rel-pos + windowing, prompt encoder, two-way
# transformer mask decoder.
_REF_SAM_RULES = [
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

def _leaf(tail: str) -> str:
    return "bias" if tail == "hbias" else tail


def _detr_prepass(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, arr in sd.items():
        if k == "query_embed.weight":  # nn.Embedding -> plain (Q,C) param
            out["query_embed"] = np.asarray(arr)
        else:
            out[k] = arr
    return out


# DETR (simpleAICV/detection/models/detr.py:44-400): post-norm 6+6 transformer
# with nn.MultiheadAttention (packed in_proj expanded by _expand_mha_keys);
# reg head = Sequential(Linear,ReLU)x2 + Linear at indices 0/2/4.
_REF_DETR_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^proj_conv$", "proj_conv"),
    (r"^transformer\.(encoder|decoder)_blocks\.(\d+)\."
     r"(attention|multihead_attention)\.__mha_([qkv])__\.(kernel|hbias)$",
     lambda m: (f"{m.group(1)}_{m.group(2)}/{m.group(3)}/{m.group(4)}/"
                f"{_leaf(m.group(5))}")),
    (r"^transformer\.(encoder|decoder)_blocks\.(\d+)\."
     r"(attention|multihead_attention)\.out_proj$",
     r"\1_\2/\3/out"),
    (r"^transformer\.(encoder|decoder)_blocks\.(\d+)\.(norm\d|linear\d)$",
     r"\1_\2/\3"),
    (r"^transformer\.decoder_norm$", "decoder_norm"),
    (r"^query_embed$", "query_embed"),
    (r"^head\.cls_head$", "cls_head"),
    (r"^head\.reg_head\.0$", "reg_head_0"),
    (r"^head\.reg_head\.2$", "reg_head_1"),
    (r"^head\.reg_head\.4$", "reg_head_out"),
]

def _dinodetr_prepass(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """nn.Embedding / nn.Parameter leaves that land as whole tensors
    (plain parameters of the port's model), keyed so the generic
    weight->kernel naming never touches them. The decoder re-registers bbox_embed/class_embed
    (reference dinodetr.py:118-119: ``transformer.decoder.bbox_embed =
    self.bbox_embed``), so the ``transformer.decoder.*_embed`` duplicates
    are dropped here."""
    out = {}
    for k, arr in sd.items():
        if k.startswith(("transformer.decoder.bbox_embed.",
                         "transformer.decoder.class_embed.")):
            continue  # duplicate registration of the shared ModuleLists
        if k == "label_encoder.weight":
            out["label_encoder.embedding"] = np.asarray(arr)
        elif k == "transformer.tgt_embed.weight":
            out["tgt_embed"] = np.asarray(arr)
        elif k == "transformer.level_embed":
            out["level_embed"] = np.asarray(arr)
        else:
            out[k] = arr
    return out


# DINO-DETR (simpleAICV/detection/models/dinodetr.py:22-449 +
# deformable_transformer.py:105-720): detr_resnet backbone, 5-level input
# projections (Sequential [conv, GroupNorm]), 6+6 deformable transformer
# (MSDeformAttn linears share names both sides), packed-MHA decoder
# self-attention, two-stage enc heads, per-layer shared bbox/class heads.
_REF_DINODETR_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^input_proj_layers\.(\d+)\.0$", r"input_proj_\1"),
    (r"^input_proj_layers\.(\d+)\.1$", r"input_proj_gn_\1"),
    (r"^label_encoder\.embedding$", "label_encoder/embedding"),
    (r"^tgt_embed$", "tgt_embed"),
    (r"^level_embed$", "level_embed"),
    (r"^transformer\.enc_output$", "enc_output"),
    (r"^transformer\.enc_output_norm$", "enc_output_norm"),
    (r"^transformer\.enc_out_class_embed\.cls_head$", "enc_out_class_embed"),
    (r"^transformer\.enc_out_bbox_embed\.reg_head\.([024])$",
     lambda m: f"enc_out_bbox_embed/layers_{int(m.group(1)) // 2}"),
    (r"^transformer\.encoder\.layers\.(\d+)\.self_attn\."
     r"(sampling_offsets|attention_weights|value_proj|output_proj)$",
     r"encoder_\1/self_attn/\2"),
    (r"^transformer\.encoder\.layers\.(\d+)\.(norm\d|linear\d)$",
     r"encoder_\1/\2"),
    (r"^transformer\.decoder\.layers\.(\d+)\.cross_attn\."
     r"(sampling_offsets|attention_weights|value_proj|output_proj)$",
     r"decoder_\1/cross_attn/\2"),
    (r"^transformer\.decoder\.layers\.(\d+)\.self_attn\."
     r"__mha_([qkv])__\.(kernel|hbias)$",
     lambda m: (f"decoder_{m.group(1)}/self_attn/{m.group(2)}/"
                f"{_leaf(m.group(3))}")),
    (r"^transformer\.decoder\.layers\.(\d+)\.self_attn\.out_proj$",
     r"decoder_\1/self_attn/out"),
    (r"^transformer\.decoder\.layers\.(\d+)\.(norm\d|linear\d)$",
     r"decoder_\1/\2"),
    (r"^transformer\.decoder\.norm$", "decoder_norm"),
    (r"^transformer\.decoder\.ref_point_head\.mlp_head\.([02])$",
     lambda m: f"ref_point_head/layers_{int(m.group(1)) // 2}"),
    (r"^bbox_embed\.(\d+)\.reg_head\.([024])$",
     lambda m: f"bbox_embed_{m.group(1)}/layers_{int(m.group(2)) // 2}"),
    (r"^class_embed\.(\d+)\.cls_head$", r"class_embed_\1"),
]


# SOLOv2 (simpleAICV/instance_segmentation/models/solov2.py:36-584).
_REF_SOLOV2_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^fpn\.lateral_conv_layers\.(\d)$", r"fpn/lateral_\1"),
    (r"^fpn\.fpn_conv_layers\.(\d)$", r"fpn/fpn_\1"),
    (r"^mask_feature_head\.(level_\d_conv\d|pred_conv)\.(conv|gn)$",
     r"mask_feature_head/\1/\2"),
    (r"^bbox_head\.(cate|kernel)_conv_layers\.(\d)\.(conv|gn)$",
     r"bbox_head/\1_conv_\2/\3"),
    (r"^bbox_head\.(cate|kernel)_pred_conv$", r"bbox_head/\1_pred_conv"),
]

# reference Darknet19 (classification/backbones/darknet.py:147-250):
# ConvBnAct Sequentials (layer.0 = conv, layer.1 = bn) and per-stage
# Darknet19Block Sequentials keyed by class name.
_REF_DARKNET19_RULES = [
    (r"^layer1\.layer\.0$", "layer1/conv"),
    (r"^layer1\.layer\.1$", "layer1/bn"),
    (r"^layer(\d)\.Darknet19Block\.(\d+)\.layer\.0$", r"layer\1/conv\2/conv"),
    (r"^layer(\d)\.Darknet19Block\.(\d+)\.layer\.1$", r"layer\1/conv\2/bn"),
    (r"^layer7\.layer\.0$", "layer7/conv"),
]

# reference VAN (classification/backbones/van.py:322-357): overlapping
# patch embeds with BN, LKA spatial-gating blocks with per-block BN norms
# and layer-scale parameters, per-stage final BN, linear head.
_REF_VAN_RULES = [
    (r"^patch_embed(\d)\.(proj|norm)$", r"patch_embed\1/\2"),
    (r"^block(\d)\.(\d+)\.(norm\d)$", r"block\1_\2/\3"),
    (r"^block(\d)\.(\d+)\.attn\.(proj_\d)$", r"block\1_\2/attn/\3"),
    (r"^block(\d)\.(\d+)\.attn\.spatial_gating_unit"
     r"\.(conv0|conv_spatial|conv1)$",
     r"block\1_\2/attn/spatial_gating_unit/\3"),
    (r"^block(\d)\.(\d+)\.mlp\.dwconv\.dwconv$", r"block\1_\2/mlp/dwconv"),
    (r"^block(\d)\.(\d+)\.mlp\.(fc\d)$", r"block\1_\2/mlp/\3"),
    (r"^block(\d)\.(\d+)\.(layer_scale_\d)$", r"block\1_\2/\3"),
    (r"^norm(\d)$", r"norm\1"),
    (r"^head$", "head"),
]

# reference YOLACT (instance_segmentation/models/yolact.py:36-355):
# backbone + YOLACTFPN + ProtoNet + shared head + semantic seg conv; the
# torch Sequentials interleave convs (even indices) with ReLU/Tanh.
_REF_YOLACT_RULES = _ref_resnet_rules("backbone.", "backbone/", False) + [
    (r"^fpn\.lat_layer_(p\d)$", r"fpn/lat_\1"),
    (r"^fpn\.pred_layers_(p\d)\.0$", r"fpn/pred_\1"),
    (r"^fpn\.downsample_layers_(p\d)\.0$", r"fpn/down_\1"),
    (r"^proto_net\.proto_layers1\.(\d)$",
     lambda m: f"proto_net/proto1_{int(m.group(1)) // 2}"),
    (r"^proto_net\.proto_layers2\.(\d)$",
     lambda m: f"proto_net/proto2_{int(m.group(1)) // 2}"),
    (r"^head\.conv1\.0$", "head/conv1"),
    (r"^head\.(bbox|conf)_pred_conv$", r"head/\1_pred_conv"),
    (r"^head\.coef_pred_conv\.0$", "head/coef_pred_conv"),
    (r"^semantic_seg_conv$", "semantic_seg_conv"),
]

def _van_prepass(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """VAN layer_scale parameters are stored (1, C, 1, 1); ours are (C,)."""
    return {k: (np.asarray(v).reshape(-1) if "layer_scale" in k else v)
            for k, v in sd.items()}


FAMILY_PREPASS = {
    "ref_sam": _sam_prepass,
    "ref_detr": _detr_prepass,
    "ref_dinodetr": _dinodetr_prepass,
    "ref_van": _van_prepass,
}

FAMILIES = {
    "torchvision_resnet": _RESNET_RULES,
    "ref_resnet": _REF_RESNET_RULES,
    "ref_fcos": _REF_FCOS_RULES,
    "ref_retinanet": _REF_RETINANET_RULES,
    "ref_deeplab": _REF_DEEPLAB_RULES,
    "ref_pfan_segmentation": _REF_PFAN_SEG_RULES,
    "ref_pfan_matting": _REF_PFAN_MATTING_RULES,
    "ref_dbnet": _REF_DBNET_RULES,
    "ref_ctc": _REF_CTC_RULES,
    "ref_retinaface": _REF_RETINAFACE_RULES,
    "ref_diffusion_unet": _REF_DIFFUSION_UNET_RULES,
    "ref_sam": _REF_SAM_RULES,
    "ref_detr": _REF_DETR_RULES,
    "ref_dinodetr": _REF_DINODETR_RULES,
    "ref_solov2": _REF_SOLOV2_RULES,
    "ref_yolact": _REF_YOLACT_RULES,
    "ref_van": _REF_VAN_RULES,
    "ref_darknet19": _REF_DARKNET19_RULES,
    "mae_vit": _MAE_VIT_RULES,
    "dinov2_vit": _DINOV2_VIT_RULES,
    "ref_mae_pretrain": _REF_MAE_PRETRAIN_RULES,
    "convformer": _CONVFORMER_RULES,
    "inception_v3": _INCEPTION_RULES,
    "sapiens_vit": _SAPIENS_RULES,
    "ref_sapiens": _REF_SAPIENS_RULES,
}


def _expand_lstm_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A packed ``nn.LSTM`` (``<prefix>.weight_ih_l0`` [4H, in], ...) cut
    into its gates, in torch's layout, under the synthetic keys
    ``<prefix>.__lstm_{fwd,bwd}__.{ii,if,ig,io,hi,hf,hg,ho}.{kernel,hbias}``
    that the family rules place; the two biases summed into the hidden
    gates' ``hbias``."""
    out = {}
    lstm: Dict[Tuple[str, str], dict] = {}
    for k, arr in sd.items():
        m = re.match(r"^(.*)\.(weight|bias)_(ih|hh)_l0(_reverse)?$", k)
        if not m:
            out[k] = arr
            continue
        direction = "bwd" if m.group(4) else "fwd"
        lstm.setdefault((m.group(1), direction), {})[
            f"{m.group(2)}_{m.group(3)}"] = np.asarray(arr)
    for (prefix, direction), parts in lstm.items():
        w_ih, w_hh = parts["weight_ih"], parts["weight_hh"]
        bias = parts["bias_ih"] + parts["bias_hh"]
        h = w_hh.shape[1]
        base = f"{prefix}.__lstm_{direction}__"
        for gi, g in enumerate("ifgo"):
            sl = slice(gi * h, (gi + 1) * h)
            out[f"{base}.i{g}.kernel"] = w_ih[sl]
            out[f"{base}.h{g}.kernel"] = w_hh[sl]
            out[f"{base}.h{g}.hbias"] = bias[sl]
    return out


def _expand_mha_keys(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A packed ``nn.MultiheadAttention`` ``in_proj_weight`` [3C, C] (and
    its bias) split into q, k and v under the synthetic keys
    ``<prefix>.__mha_{q,k,v}__.{kernel,hbias}``, in torch's layout."""
    out = {}
    packs: Dict[str, dict] = {}
    for k, arr in sd.items():
        m = re.match(r"^(.*)\.in_proj_(weight|bias)$", k)
        if not m:
            out[k] = arr
            continue
        packs.setdefault(m.group(1), {})[m.group(2)] = np.asarray(arr)
    for prefix, parts in packs.items():
        w, b = parts["weight"], parts.get("bias")
        c = w.shape[1]
        for i, g in enumerate("qkv"):
            out[f"{prefix}.__mha_{g}__.kernel"] = w[i * c:(i + 1) * c]
            if b is not None:
                out[f"{prefix}.__mha_{g}__.hbias"] = b[i * c:(i + 1) * c]
    return out


def _rewrite(module_path: str, rules) -> str | None:
    for pat, repl in rules:
        m = re.match(pat, module_path)
        if m:
            return m.expand(repl) if isinstance(repl, str) else repl(m)
    return None


def _leaf_path(target: str, suffix: str, ndim: int) -> str:
    """The JAX tree's path of a module's tensor: a BatchNorm statistic in
    ``batch_stats``, a weight as a kernel (2-D and 4-D), an embedding
    table (a 2-D ``*embed``, but DINO-DETR's linear
    ``enc_out_class_embed``) or a norm's scale."""
    if suffix in ("running_mean", "running_var"):
        return f"{BATCH_STATS}{target}/{suffix[len('running_'):]}"
    if suffix == "weight":
        leaf = target.rsplit("/", 1)[-1]
        if (ndim == 2 and leaf.endswith("embed")
                and leaf != "enc_out_class_embed"):
            return f"{target}/embedding"
        return f"{target}/{'kernel' if ndim in (2, 4) else 'scale'}"
    return f"{target}/{suffix}"


def convert_official_state_dict(sd, family: str) -> Dict[str, torch.Tensor]:
    """state_dict (tensors or arrays, torch's names and layouts) ->
    {JAX tree path: f32 tensor in torch's layout}. Keys no rule names are
    dropped, as the reference's converters drop them by key filter."""
    rules = FAMILIES[family]
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    sd = _expand_mha_keys(_expand_lstm_keys(sd))
    if family in FAMILY_PREPASS:
        sd = FAMILY_PREPASS[family](sd)
    out = {}
    for key, arr in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        module_path, _, suffix = key.rpartition(".")
        if suffix not in ("weight", "bias", "running_mean", "running_var"):
            module_path, suffix = key, ""
        target = _rewrite(module_path, rules)
        if target is None:
            continue
        path = _leaf_path(target, suffix, arr.ndim) if suffix else target
        out[path] = torch.from_numpy(np.ascontiguousarray(arr)).float()
    return out


def _gathered(keys, paths, converted):
    """{state_dict key: tensor} of one of the bridge's groups, or {} where
    the converted tree does not hold all its leaves. An LSTM's gates are
    joined in torch's order; its ``bias_ih`` is 0 (the port's cells keep
    the summed bias in ``bias_hh``)."""
    if not all(p in converted for p in paths):
        return {}
    pieces = [converted[p] for p in paths]
    if len(paths) == 1:
        return {keys[0]: pieces[0]}
    joined = torch.cat(pieces, 0)
    if len(keys) == 1:
        return {keys[0]: joined}
    return {keys[0]: torch.zeros_like(joined), keys[1]: joined}


def apply_converted(model: torch.nn.Module, converted: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.nn.Module, int]:
    """Loads a converted tree into ``model`` (every tensor whose leaf the
    model has, with the same shape or a resizable position embedding);
    returns (model, the number of ``state_dict`` entries loaded)."""
    named = {}
    for keys, paths, _, _ in _leaves(model, ""):
        named.update(_gathered(keys, paths, converted))
    tensors, n = load_state_dict_partial(named, model.state_dict())
    model.load_state_dict(tensors)
    return model, n


def convert_torch_file(path: str, family: str) -> Dict[str, torch.Tensor]:
    from .weight_convert import load_torch_state_dict
    return convert_official_state_dict(load_torch_state_dict(path), family)
