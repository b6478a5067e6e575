"""InceptionV3, the FID and Inception Score feature extractor (counterpart of
``simpleaicv_tpu/models/inception_v3.py``), eval only and in f32.

torchvision's InceptionV3 (``fid=False``) or the FID variant (``fid=True``:
average pools in the A and C blocks and in Mixed_7b that divide by the
cells under the window, a max pool in Mixed_7c, a 1008-way classifier
without bias). NHWC; the BatchNorms use their running statistics (eps
1e-3). The modules keep torchvision's names (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, ``fc``), so a torchvision or ``pt_inception``
FID state dict loads with ``load_state_dict`` (its ``num_batches_tracked``
counters are dropped), and the JAX package's ``inception_v3`` converter
reads this model's ``state_dict``.

[N, 299, 299, 3] images in [-1, 1] -> (pool3 features [N, 2048], logits
[N, classes]).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, Linear

__all__ = ["InceptionV3"]


class BasicConv2d(nn.Module):

    def __init__(self, in_planes: int, planes: int, kernel: Sequence[int],
                 stride: int = 1, padding: Sequence[int] = (0, 0)):
        super().__init__()
        self.conv = Conv2d(in_planes, planes, kernel, stride, tuple(padding),
                           bias=False)
        self.bn = BatchNorm(planes, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x), False))


def _pad(k):
    return (k // 2, k // 2)


def _nchw(fn, x):
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _avgpool3(x, count_include_pad=True):
    """3x3 average pool, stride 1, padding 1; without ``count_include_pad``
    it divides by the cells under the window (TensorFlow's pool)."""
    return _nchw(lambda t: F.avg_pool2d(
        t, 3, 1, 1, count_include_pad=count_include_pad), x)


def _maxpool(x, k=3, s=2, p=0):
    return _nchw(lambda t: F.max_pool2d(t, k, s, p), x)


class InceptionA(nn.Module):

    def __init__(self, in_planes: int, pool_planes: int, fid: bool = False):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(in_planes, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_planes, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=_pad(5))
        self.branch3x3dbl_1 = BasicConv2d(in_planes, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=_pad(3))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=_pad(3))
        self.branch_pool = BasicConv2d(in_planes, pool_planes, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x, count_include_pad=not self.fid))
        return torch.cat([b1, b5, b3, bp], -1)


class InceptionB(nn.Module):

    def __init__(self, in_planes: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_planes, 384, 3, 2)
        self.branch3x3dbl_1 = BasicConv2d(in_planes, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=_pad(3))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool(x)], -1)


class InceptionC(nn.Module):

    def __init__(self, in_planes: int, c7: int, fid: bool = False):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(in_planes, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_planes, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_planes, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_planes, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3(x, count_include_pad=not self.fid))
        return torch.cat([self.branch1x1(x), b7, bd, bp], -1)


class InceptionD(nn.Module):

    def __init__(self, in_planes: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_planes, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 2)
        self.branch7x7x3_1 = BasicConv2d(in_planes, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool(x)], -1)


class InceptionE(nn.Module):
    """``pool``: "avg", "avg_nopad" (FID Mixed_7b) or "max" (FID
    Mixed_7c)."""

    def __init__(self, in_planes: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_planes, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_planes, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_planes, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=_pad(3))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_planes, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], -1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       -1)
        if self.pool == "max":
            p = _maxpool(x, 3, 1, 1)
        else:
            p = _avgpool3(x, count_include_pad=self.pool == "avg")
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(p)], -1)


class InceptionV3(nn.Module):

    def __init__(self, num_classes: int = 1000, fid: bool = False):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=_pad(3))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_nopad" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")
        n_cls = 1008 if fid and num_classes == 1000 else num_classes
        self.fc = Linear(2048, n_cls, bias=not fid)
        self._register_load_state_dict_pre_hook(_drop_batch_counters)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(
            x.float())))
        x = _maxpool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool = x.mean(dim=(1, 2))
        return pool, self.fc(pool)


def _drop_batch_counters(state_dict, prefix, *args):
    for key in [k for k in state_dict
                if k.startswith(prefix) and k.endswith("num_batches_tracked")]:
        del state_dict[key]
