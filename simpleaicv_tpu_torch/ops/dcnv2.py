"""DCNv2, the modulated deformable convolution (counterpart of
``simpleaicv_tpu/ops/dcnv2.py``).

``deform_conv2d(x, offsets, mask, kernel, stride)`` keeps the JAX
function's layouts: x [B, H, W, C], offsets [B, Ho, Wo, K*K*2] as (dy, dx)
per tap, mask [B, Ho, Wo, K*K] in [0, 1], kernel [K, K, C, O], SAME
padding; the result [B, Ho, Wo, O] in f32. A tap samples x bilinearly at
(output position * stride + tap - pad + offset), zero outside the image.

The JAX function reuses MSDA's bilinear gather with one level. The port
samples through ``ops/msda.py::ms_deform_attn`` the same way, so the hand
kernels K7 and K7b carry DCNv2 on the card, forward and backward: one
level, one point a query, Ho * Wo * K * K queries (one a tap), the mask as
the attention weight. The weighted sum over one point is then exactly
sample * mask. The channels go as heads of ``HEAD_DIM`` (32, the layout of
DINO-DETR's value, which the tiled kernels take) with the same location
for every head; a C that 32 does not divide goes as heads of the largest
divisor of C up to 64. The modulated samples then meet the kernel in one
matrix product.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.common import Conv2d, _lecun_normal
from .msda import ms_deform_attn

__all__ = ["deform_conv2d", "DeformConv2d", "HEAD_DIM", "sample_layout"]

HEAD_DIM = 32


def _head_dim(c: int) -> int:
    if c % HEAD_DIM == 0:
        return HEAD_DIM
    return max(d for d in range(1, min(c, 64) + 1) if c % d == 0)


def sample_layout(x, offsets, mask, k: int, stride: int = 1):
    """The MSDA inputs of a deformable convolution: (value [B, H*W, heads,
    D], spatial_shapes, locations [B, Ho*Wo*K*K, heads, 1, 1, 2] as (x, y)
    in [0, 1], weights [B, Ho*Wo*K*K, heads, 1, 1])."""
    b, h, w, c = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    d = _head_dim(c)
    heads = c // d
    pad = (k - 1) // 2
    dev = x.device
    ys = torch.arange(ho, dtype=torch.float32, device=dev) * stride
    xs = torch.arange(wo, dtype=torch.float32, device=dev) * stride
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")               # [Ho, Wo]
    ky, kx = torch.meshgrid(torch.arange(k, dtype=torch.float32, device=dev),
                            torch.arange(k, dtype=torch.float32, device=dev),
                            indexing="ij")
    off = offsets.float().reshape(b, ho, wo, k * k, 2)
    loc_x = gx[None, :, :, None] + kx.reshape(-1) - pad + off[..., 1]
    loc_y = gy[None, :, :, None] + ky.reshape(-1) - pad + off[..., 0]
    # normalised with the align_corners=False convention of the sampler
    loc = torch.stack([(loc_x + 0.5) / w, (loc_y + 0.5) / h], -1)
    lq = ho * wo * k * k
    loc = loc.reshape(b, lq, 1, 1, 1, 2).expand(b, lq, heads, 1, 1, 2)
    wts = mask.float().reshape(b, lq, 1, 1, 1).expand(b, lq, heads, 1, 1)
    value = x.float().reshape(b, h * w, heads, d)
    return value, ((h, w),), loc, wts


def deform_conv2d(x, offsets, mask, kernel, stride: int = 1):
    """x [B, H, W, C]; offsets [B, Ho, Wo, K*K*2] (dy, dx per tap); mask
    [B, Ho, Wo, K*K] in [0, 1]; kernel [K, K, C, O]. SAME padding; returns
    [B, Ho, Wo, O] f32. Differentiable in all four tensors; CUDA tensors
    sample with K7 (forward) and K7b (backward), CPU tensors with their
    plain versions."""
    b, _, _, c = x.shape
    k = kernel.shape[0]
    ho, wo = offsets.shape[1], offsets.shape[2]
    sampled = ms_deform_attn(*sample_layout(x, offsets, mask, k, stride))
    # [B, Ho*Wo*K*K, C] -> [B*Ho*Wo, K*K*C], taps then channels as the
    # kernel's rows
    out = sampled.reshape(b * ho * wo, k * k * c) @ \
        kernel.float().reshape(k * k * c, -1)
    return out.reshape(b, ho, wo, -1)


class DeformConv2d(nn.Module):
    """Modulated deformable convolution layer: a regular convolution (zero
    init) gives the offsets and the mask's logits, then
    ``deform_conv2d``. Takes and gives channels-last [B, H, W, C], as the
    JAX module does; the parameter names (``offset_mask_conv``,
    ``kernel`` [K, K, C, O], ``bias``) are the JAX tree's. Seeded by
    ``models.common.init_params``: the kernel lecun normal, the rest 0."""

    def __init__(self, inplanes: int, planes: int, kernel_size: int = 3,
                 stride: int = 1):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride = k, stride
        self.offset_mask_conv = Conv2d(inplanes, 3 * k * k, k, stride=stride,
                                       padding=(k - 1) // 2, normal_std=0.0)
        self.kernel = nn.Parameter(torch.empty(k, k, inplanes, planes))
        self.bias = nn.Parameter(torch.empty(planes))

    def reset_parameters(self, generator):
        _lecun_normal(self.kernel, self.kernel[..., 0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        k = self.kernel_size
        om = self.offset_mask_conv(x.float())
        offsets = om[..., :2 * k * k]
        mask = torch.sigmoid(om[..., 2 * k * k:])
        return deform_conv2d(x, offsets, mask, self.kernel,
                             self.stride) + self.bias
