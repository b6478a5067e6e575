"""The CTC text-recognition model (counterpart of
``simpleaicv_tpu/models/text_recognition.py``): an OCR ResNet trunk, the
mean over H in f32, a sequence encoder (two bidirectional LSTM blocks, or
a Transformer encoder) and the CTC predictor.

``OCRResNetBackbone`` keeps the width at stages 3 and 4 (stride (2, 1),
(3, 1) kernels), so a 32-high crop gives an H/32 x W/8 map and a W/8-long
sequence. ``BiLSTMEncoder`` is two (bidirectional ``nn.LSTM`` with hidden
size = width, Linear 2 x width -> width) blocks in f32: torch's reverse
direction reads the sequence reversed and returns it in order, as flax's
``nn.RNN(reverse=True, keep_order=True)`` does; ``bias_ih_l0`` stays zero
(flax's cell has one bias a gate, ``bias_hh_l0``) and takes no update.
``TransformerEncoder`` is three of the ViT's pre-norm layers (8 heads,
dropout 0.1 from the step's generator) in ``dtype``, returned in f32; its
attention is the einsum path (the JAX model leaves flash attention off).
The predictor's two Linear layers run in f32. [B, 32, W, 3] images ->
[B, W / 8, num_classes] f32 logits. NHWC; state-dict keys are the JAX
paths (``backbone.layer3.0.conv1``, ``encoder.rnn1``,
``encoder.blocks.0.attn.qkv``, ``predictor.fc2``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.registry import BACKBONES, MODELS
from .backbones.vit import TransformerEncoderLayer
from .common import ConvBnAct, Linear, checkpoint, max_pool_same, \
    truncated_normal_

__all__ = ["CTCModel", "BiLSTMEncoder", "TransformerEncoder", "CTCPredictor",
           "OCRResNetBackbone", "CTCModelFactory"]


class _OCRBasicBlock(nn.Module):
    """conv1 takes the stage's (kernel, stride); conv2 is 3x3/1."""
    expansion = 1

    def __init__(self, inplanes, planes, kernel, stride, dtype):
        super().__init__()
        self.conv1 = ConvBnAct(inplanes, planes, kernel, stride, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, 3, 1, has_act=False,
                               dtype=dtype)
        self.downsample = None
        if max(stride) != 1 or inplanes != planes:
            self.downsample = ConvBnAct(inplanes, planes, 1, stride,
                                        has_act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv2(self.conv1(x, train), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return F.relu(out + x)


class _OCRBottleneck(nn.Module):
    """The stage's (kernel, stride) lands on conv2."""
    expansion = 4

    def __init__(self, inplanes, planes, kernel, stride, dtype):
        super().__init__()
        outplanes = planes * 4
        self.conv1 = ConvBnAct(inplanes, planes, 1, 1, dtype=dtype)
        self.conv2 = ConvBnAct(planes, planes, kernel, stride, dtype=dtype)
        self.conv3 = ConvBnAct(planes, outplanes, 1, 1, has_act=False,
                               dtype=dtype)
        self.downsample = None
        if max(stride) != 1 or inplanes != outplanes:
            self.downsample = ConvBnAct(inplanes, outplanes, 1, stride,
                                        has_act=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        out = self.conv3(self.conv2(self.conv1(x, train), train), train)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return F.relu(out + x)


# each stage's first block: (kernel, stride), stages 3 and 4 keeping the
# width; the JAX package's paddings, (1, 1) and (1, 0), are (k - 1) // 2
_OCR_STAGE_SPECS = [
    ((3, 3), (1, 1)),
    ((3, 3), (2, 2)),
    ((3, 1), (2, 1)),
    ((3, 1), (2, 1)),
]


class OCRResNetBackbone(nn.Module):
    """[B, H, W, 3] -> the four stages' outputs; the last is [B, H / 32,
    W / 8, 512 x expansion]."""

    def __init__(self, basic: bool = False, layer_nums=(3, 4, 6, 3),
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        block = _OCRBasicBlock if basic else _OCRBottleneck
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.stem = ConvBnAct(3, 64, 7, 2, dtype=dtype)
        channels, planes = 64, 64
        for si, (n, (k, s)) in enumerate(zip(layer_nums, _OCR_STAGE_SPECS)):
            blocks = []
            for bi in range(n):
                bk, bs = (k, s) if bi == 0 else ((3, 3), (1, 1))
                blocks.append(block(channels, planes, bk, bs, dtype))
                channels = planes * block.expansion
            self.add_module(f"layer{si + 1}", nn.ModuleList(blocks))
            planes *= 2
        self.num_stages = len(layer_nums)
        self.out_channels = channels

    def forward(self, x, train: bool = False):
        x = max_pool_same(self.stem(x, train), 3, 2)
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        features = []
        for stage in range(self.num_stages):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = checkpoint(blk, x, train) if remat else blk(x, train)
            features.append(x)
        return tuple(features)


_OCR_BACKBONES = {
    "resnet18": dict(basic=True, layer_nums=(2, 2, 2, 2)),
    "resnet34": dict(basic=True, layer_nums=(3, 4, 6, 3)),
    "resnet50": dict(basic=False, layer_nums=(3, 4, 6, 3)),
    "resnet101": dict(basic=False, layer_nums=(3, 4, 23, 3)),
    "resnet152": dict(basic=False, layer_nums=(3, 8, 36, 3)),
}


class _BiLSTM(nn.LSTM):
    """A one-layer bidirectional ``nn.LSTM`` (batch first) initialised as
    flax's ``OptimizedLSTMCell``: each gate's input kernel lecun normal
    (truncated), each gate's recurrent kernel orthogonal, biases zero;
    ``bias_ih`` fixed at zero."""

    def __init__(self, features: int, hidden: int):
        super().__init__(features, hidden, batch_first=True,
                         bidirectional=True)
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            getattr(self, name).requires_grad_(False)

    def reset_parameters(self, generator=None):
        if generator is None:  # nn.LSTM's own call from its constructor
            return
        hidden = self.hidden_size
        with torch.no_grad():
            for sfx in ("", "_reverse"):
                w_ih = getattr(self, f"weight_ih_l0{sfx}")
                w_hh = getattr(self, f"weight_hh_l0{sfx}")
                for g in range(4):
                    rows = slice(g * hidden, (g + 1) * hidden)
                    kernel = torch.empty(w_ih.shape[1], hidden)
                    truncated_normal_(kernel, 1.0 / math.sqrt(w_ih.shape[1]),
                                      generator)
                    w_ih[rows] = kernel.T
                    w_hh[rows] = _orthogonal(hidden, generator).T
                getattr(self, f"bias_ih_l0{sfx}").zero_()
                getattr(self, f"bias_hh_l0{sfx}").zero_()


def _orthogonal(n: int, generator):
    """flax's ``orthogonal()`` for an [n, n] kernel: Q of a normal matrix's
    QR, its columns' signs set by R's diagonal."""
    a = torch.randn(n, n, generator=generator)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))


class BiLSTMEncoder(nn.Module):
    """Two (BiLSTM, hidden = width -> Linear 2 x width -> width) blocks, in
    f32."""

    def __init__(self, planes: int, hidden: int | None = None):
        super().__init__()
        hidden = hidden or planes
        for i in (1, 2):
            self.add_module(f"rnn{i}", _BiLSTM(planes, hidden))
            self.add_module(f"linear{i}", Linear(2 * hidden, planes))

    def forward(self, x, generator=None):
        x = x.float()
        for i in (1, 2):
            out, _ = getattr(self, f"rnn{i}")(x)
            x = getattr(self, f"linear{i}")(out)
        return x


class TransformerEncoder(nn.Module):
    """``block_nums`` pre-norm ViT layers in ``dtype``, returned in f32."""

    def __init__(self, planes: int, block_nums: int = 3, head_nums: int = 8,
                 feedforward_ratio: int = 4, dropout_prob: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList([
            TransformerEncoderLayer(planes, head_nums, feedforward_ratio,
                                    dropout_prob, 0.0, dtype=dtype)
            for _ in range(block_nums)])

    def forward(self, x, generator=None):
        x = x.to(self.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        return x.float()


class CTCPredictor(nn.Module):

    def __init__(self, planes: int, hidden_planes: int = 512,
                 num_classes: int = 12114):
        super().__init__()
        self.fc1 = Linear(planes, hidden_planes)
        self.fc2 = Linear(hidden_planes, num_classes)

    def forward(self, x):
        return self.fc2(self.fc1(x))


class CTCModel(nn.Module):
    """[B, H, W, 3] -> [B, W / 8, num_classes] f32 logits."""

    def __init__(self, backbone_type: str = "resnet50",
                 encoder_type: str = "BiLSTMEncoder",
                 predictor_hidden_planes: int = 512,
                 num_classes: int = 12114,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if backbone_type in _OCR_BACKBONES:
            self.backbone = OCRResNetBackbone(
                use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype,
                **_OCR_BACKBONES[backbone_type])
            planes = self.backbone.out_channels
        else:
            self.backbone = BACKBONES.create(
                backbone_type, features_only=True,
                use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
            planes = self.backbone.feature_channels[-1]
        if encoder_type == "TransformerEncoder":
            self.encoder = TransformerEncoder(planes, dtype=dtype)
        elif encoder_type == "BiLSTMEncoder":
            self.encoder = BiLSTMEncoder(planes)
        else:
            raise KeyError(f"unknown encoder {encoder_type!r}")
        self.predictor = CTCPredictor(planes, predictor_hidden_planes,
                                      num_classes)

    def forward(self, x, train: bool | None = None, generator=None):
        """``train`` defaults to the module's mode; the Transformer's
        dropout draws from ``generator`` in training."""
        if train is None:
            train = self.training
        x = self.backbone(x, train)[-1]
        x = x.float().mean(dim=1)
        return self.predictor(self.encoder(x, generator))


@MODELS.register()
def CTCModelFactory(model_config, use_gradient_checkpoint=False):
    """The reference's nested ``model_config`` dict surface."""
    return CTCModel(
        backbone_type=model_config["backbone"]["name"].replace("backbone", ""),
        encoder_type=model_config["encoder"]["name"],
        predictor_hidden_planes=model_config["predictor"]["param"].get(
            "hidden_planes", 512),
        num_classes=model_config["predictor"]["param"]["num_classes"],
        use_gradient_checkpoint=use_gradient_checkpoint)
