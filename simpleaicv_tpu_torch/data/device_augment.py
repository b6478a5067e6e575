"""Batched data augmentation on the card (counterpart of
``simpleaicv_tpu/data/device_augment.py``): AutoAugment, RandAugment,
normalisation, random erasing and mixup/cutmix as torch ops over a
[B, H, W, 3] f32 batch on the uint8 lattice, run inside the engine's train
step (``make_train_step``'s ``augment_fn``), with PIL's semantics:

* **one affine warp** for ShearX/Y, TranslateX/Y (absolute and relative)
  and Rotate: PIL's 16.16 fixed-point inverse map in int32 (``>>`` is an
  arithmetic shift on negative values) and a gather of each output pixel's
  source pixel; pixels mapped outside the image take the fill colour 128;
* **closed-form point ops** for Invert, Solarize, SolarizeAdd, Posterize
  and AutoContrast;
* **Equalize** from an integer histogram per (image, channel), counted by
  ``scatter_add_`` (exact), PIL's integer LUT rules, and the LUT applied by
  ``gather``;
* **one blend** for Brightness, Color, Contrast and Sharpness against
  their degenerate images (black, grayscale, mean gray, smoothed), with
  PIL's truncation.

The JAX package's one-hot matmul forms of the warp and the histogram were
for the TPU and are not ported.

Each policy class splits into ``draw`` (its random numbers, from the step's
``torch.Generator``) and ``apply`` (deterministic given the draws), so the
tests can feed both packages the same draws; ``__call__`` does both. The
draws of one op slot are the JAX ``_row_draws``'s: (apply, arg, cls, kind)
per image. Mixup/cutmix's one (lambda_mixup, lambda_cutmix) pair a batch
is drawn on the host by numpy's Beta sampler from a ``PCG64`` seeded by the
step generator's seed (``Generator.initial_seed()``, which the engine's
``step_generator`` sets from the run's seed and the step): torch has no
Beta sampler that takes a generator.

Numbers: the geometric and table ops are exact against the JAX package's
and PIL's, except that Rotate's f32 ``cos``/``sin`` may part from XLA's by
an ulp and move single pixels (``tests/test_torch_device_augment.py``
states the bound); the blends and AutoContrast within one level (PIL's own
f32 rounding, and the order of a sum).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .auto_rand_augment import (_MAX_LEVEL, _POLICIES,
                                _RAND_INCREASING_TRANSFORMS, _RAND_TRANSFORMS,
                                _TRANSLATE_CONST)

__all__ = [
    "DeviceAutoAugment", "DeviceRandAugment", "DeviceNormalize",
    "DeviceRandomErasing", "DeviceMixupCutmix", "DeviceAugmentPipeline",
    "apply_op",
]

_FILL = 128.0

# op classes
_CLS_ID, _CLS_GEOM, _CLS_LUT, _CLS_BLEND = 0, 1, 2, 3
# geometric kinds
_G_SHEARX, _G_SHEARY, _G_TXABS, _G_TYABS, _G_TXREL, _G_TYREL, _G_ROT = \
    1, 2, 3, 4, 5, 6, 7
# LUT kinds
_L_INV, _L_SOL, _L_SOLADD, _L_POST, _L_EQ, _L_AC = 1, 2, 3, 4, 5, 6
# blend kinds
_B_BRIGHT, _B_COLOR, _B_CONTRAST, _B_SHARP = 1, 2, 3, 4

# The level -> argument rule of ``auto_rand_augment._level_to_arg`` as one
# formula over a row of numbers:
#   m = clip(level_jittered, 0, 10) / 10
#   inner = p1 * m ; f = floor(inner) if cast else inner
#   sign = +/-1 with prob 1/2 if neg else +1
#   arg = clip(q0 + q1 * sign * f, qlo, qhi)
# row layout: [prob, op_class, kind, p1, cast, q0, q1, neg, qlo, qhi, level]
_ROW_LEN = 11


def _op_spec(name):
    inf = 1e30
    if name == "AutoContrast":
        return (_CLS_LUT, _L_AC, 1, 0, 0, 0, 0, 0, 0)
    if name == "Equalize":
        return (_CLS_LUT, _L_EQ, 1, 0, 0, 0, 0, 0, 0)
    if name == "Invert":
        return (_CLS_LUT, _L_INV, 1, 0, 0, 0, 0, 0, 0)
    if name == "Rotate":
        return (_CLS_GEOM, _G_ROT, 1, 0, 0, 30.0, 1, -inf, inf)
    if name == "Posterize":
        return (_CLS_LUT, _L_POST, 4, 1, 0, 1, 0, 0, 8)
    if name == "PosterizeIncreasing":
        return (_CLS_LUT, _L_POST, 4, 1, 4, -1, 0, 0, 8)
    if name == "PosterizeOriginal":
        return (_CLS_LUT, _L_POST, 4, 1, 4, 1, 0, 0, 8)
    if name == "Solarize":
        return (_CLS_LUT, _L_SOL, 256, 1, 0, 1, 0, 0, 256)
    if name == "SolarizeIncreasing":
        return (_CLS_LUT, _L_SOL, 256, 1, 256, -1, 0, 0, 256)
    if name == "SolarizeAdd":
        return (_CLS_LUT, _L_SOLADD, 110, 1, 0, 1, 0, 0, 128)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        kind = {"Brightness": _B_BRIGHT, "Color": _B_COLOR,
                "Contrast": _B_CONTRAST, "Sharpness": _B_SHARP}[name]
        return (_CLS_BLEND, kind, 1, 0, 0.1, 1.8, 0, -inf, inf)
    if name in ("ColorIncreasing", "ContrastIncreasing",
                "BrightnessIncreasing", "SharpnessIncreasing"):
        kind = {"BrightnessIncreasing": _B_BRIGHT, "ColorIncreasing": _B_COLOR,
                "ContrastIncreasing": _B_CONTRAST,
                "SharpnessIncreasing": _B_SHARP}[name]
        return (_CLS_BLEND, kind, 1, 0, 1.0, 0.9, 1, 0.1, inf)
    if name == "ShearX":
        return (_CLS_GEOM, _G_SHEARX, 1, 0, 0, 0.3, 1, -inf, inf)
    if name == "ShearY":
        return (_CLS_GEOM, _G_SHEARY, 1, 0, 0, 0.3, 1, -inf, inf)
    if name == "TranslateX":
        return (_CLS_GEOM, _G_TXABS, 1, 0, 0, _TRANSLATE_CONST, 1, -inf, inf)
    if name == "TranslateY":
        return (_CLS_GEOM, _G_TYABS, 1, 0, 0, _TRANSLATE_CONST, 1, -inf, inf)
    if name == "TranslateXRel":
        return (_CLS_GEOM, _G_TXREL, 1, 0, 0, 0.45, 1, -inf, inf)
    if name == "TranslateYRel":
        return (_CLS_GEOM, _G_TYREL, 1, 0, 0, 0.45, 1, -inf, inf)
    raise KeyError(name)


def _row(name, prob, level):
    cls, kind, p1, cast, q0, q1, neg, qlo, qhi = _op_spec(name)
    return [prob, cls, kind, p1, cast, q0, q1, neg, qlo, qhi, float(level)]


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------

def _quantize(img):
    """The host path's float -> uint8 lattice (a truncating cast)."""
    return torch.floor(torch.clamp(img, 0.0, 255.0))


def _grayscale_l(img):
    """PIL convert('L'), ITU-R 601-2 in fixed point; exact (ints < 2^24)."""
    v = (img[..., 0] * 19595.0 + img[..., 1] * 38470.0 +
         img[..., 2] * 7471.0 + 32768.0)
    return torch.floor(v / 65536.0)


def _smooth(img):
    """PIL ImageFilter.SMOOTH: 3x3 [[1,1,1],[1,5,1],[1,1,1]]/13, rounded,
    the 1-pixel border kept from the input."""
    k = torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]],
                     device=img.device) / 13.0
    x = img.permute(0, 3, 1, 2)                           # [B, C, H, W]
    b, c, h, w = x.shape
    y = F.conv2d(x.reshape(b * c, 1, h, w), k[None, None])
    y = torch.floor(y.reshape(b, c, h - 2, w - 2) + 0.5)
    out = x.clone()
    out[:, :, 1:-1, 1:-1] = torch.clamp(y, 0.0, 255.0)
    return out.permute(0, 2, 3, 1)


def _warp_indices(mat, h, w):
    """PIL's 16.16 fixed-point inverse map: the source column and row
    [B, H, W] (int32) of every output pixel. PIL's ImagingTransformAffine
    quantizes each coefficient with ``FIX(v) = floor(v * 65536 + .5)`` and
    accumulates along rows and columns, so
    ``src_x(y, x) = (FIX(a*.5 + b*.5 + c) + y*FIX(b) + x*FIX(a)) >> 16``.
    int32 bounds the extents and translations to < 2^15 pixels."""

    def fix(v):
        return torch.floor(v * 65536.0 + 0.5).to(torch.int32)[:, None, None]

    a, bb, cc, d, e, f = mat.unbind(1)
    x0 = fix(a * 0.5 + bb * 0.5 + cc)
    y0 = fix(d * 0.5 + e * 0.5 + f)
    dxc, dxr, dyc, dyr = fix(a), fix(bb), fix(d), fix(e)
    ys = torch.arange(h, dtype=torch.int32, device=mat.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.int32, device=mat.device)[None, None, :]
    sx = (x0 + ys * dxr + xs * dxc) >> 16
    sy = (y0 + ys * dyr + xs * dyc) >> 16
    return sx, sy


def _affine_warp(img, mat):
    """PIL Image.transform(AFFINE, nearest), bit-exact: a gather of each
    output pixel's source pixel; out-of-bounds pixels take the fill."""
    bsz, h, w, c = img.shape
    sx, sy = _warp_indices(mat, h, w)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    idx = (sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)).to(torch.int64)
    out = img.reshape(bsz, h * w, c).gather(
        1, idx.reshape(bsz, h * w, 1).expand(-1, -1, c)).reshape(img.shape)
    return torch.where(valid[..., None], out, _FILL)


def _geom_matrices(kind, arg, h, w):
    """Per-image PIL inverse-affine coefficients [B, 6] (f32)."""
    zero = torch.zeros_like(arg)
    one = torch.ones_like(arg)
    vx = torch.where(kind == _G_TXREL, arg * w,
                     torch.where(kind == _G_TXABS, arg, zero))
    vy = torch.where(kind == _G_TYREL, arg * h,
                     torch.where(kind == _G_TYABS, arg, zero))
    b = torch.where(kind == _G_SHEARX, arg, zero)
    d = torch.where(kind == _G_SHEARY, arg, zero)
    lin = torch.stack([one, b, vx, d, one, vy], dim=-1)
    # rotate: PIL Image.rotate(angle) about the centre (w/2, h/2)
    t = -arg * (math.pi / 180.0)
    cos, sin = torch.cos(t), torch.sin(t)
    cx, cy = w / 2.0, h / 2.0
    rot = torch.stack([cos, sin, cx - cos * cx - sin * cy,
                       -sin, cos, cy + sin * cx - cos * cy], dim=-1)
    return torch.where((kind == _G_ROT)[:, None], rot, lin)


def _channel_values(img):
    """The lattice values as [B, 3, P] int64."""
    bsz = img.shape[0]
    return img.permute(0, 3, 1, 2).reshape(bsz, 3, -1).to(torch.int64)


def _histogram(values):
    """[B, 3, 256] int64 counts of ``values`` [B, 3, P] by ``scatter_add_``
    over (image, channel, value): exact integer counts."""
    bsz = values.shape[0]
    rows = torch.arange(bsz * 3, device=values.device).reshape(bsz, 3, 1)
    hist = torch.zeros(bsz * 3 * 256, dtype=torch.int32,
                       device=values.device)
    hist.scatter_add_(0, (rows * 256 + values).reshape(-1),
                      torch.ones(values.numel(), dtype=torch.int32,
                                 device=values.device))
    return hist.reshape(bsz, 3, 256).to(torch.int64)


def _equalize(img):
    """PIL ImageOps.equalize, in integers: ``step = (npix -
    hist[last nonzero]) // 255``, ``lut[i] = clip((step // 2 +
    cumsum_excl(hist)[i]) // step, 0, 255)``, the identity where ``step`` is
    0 or the channel occupies one bin; the LUT applied by ``gather``."""
    values = _channel_values(img)
    hist = _histogram(values)
    npix = img.shape[1] * img.shape[2]
    nz = hist > 0
    last = 255 - torch.argmax(nz.flip(-1).to(torch.int32), dim=-1)
    h_last = hist.gather(-1, last[..., None])[..., 0]
    step = (npix - h_last) // 255
    cum_excl = torch.cumsum(hist, dim=-1) - hist
    lut = torch.clamp(((step // 2)[..., None] + cum_excl)
                      // torch.clamp(step, min=1)[..., None], 0, 255)
    ident = torch.arange(256, device=img.device).expand_as(lut)
    degenerate = (step < 1) | (nz.sum(dim=-1) <= 1)
    lut = torch.where(degenerate[..., None], ident, lut)
    out = lut.gather(-1, values).to(img.dtype)
    return out.reshape(img.shape[0], 3, img.shape[1],
                       img.shape[2]).permute(0, 2, 3, 1)


def _apply_point_ops(img, kind, arg, want_eq, want_ac):
    """The LUT-class ops in closed form (each branch the formula of the
    256-entry table the host path builds), Equalize by its integer LUT."""
    k = kind[:, None, None, None]
    a = arg[:, None, None, None]
    out = img                                            # identity default
    out = torch.where(k == _L_INV, 255.0 - img, out)
    out = torch.where(k == _L_SOL, torch.where(img < a, img, 255.0 - img),
                      out)
    out = torch.where(k == _L_SOLADD,
                      torch.where(img < 128.0,
                                  torch.clamp(img + a, 0.0, 255.0), img), out)
    # posterize: keep the top `bits`; bits == 0 gives black
    shift = torch.exp2(8.0 - torch.clamp(a, 0.0, 8.0))
    out = torch.where(k == _L_POST, torch.floor(img / shift) * shift, out)
    if want_ac:
        # PIL ImageOps.autocontrast(cutoff=0): lut[i] = clip(trunc(i * scale
        # - lo * scale)); the identity where the channel is constant
        lo = img.amin(dim=(1, 2), keepdim=True)          # [B, 1, 1, 3]
        hi = img.amax(dim=(1, 2), keepdim=True)
        scale = 255.0 / torch.clamp(hi - lo, min=1.0)
        ac = torch.clamp(torch.floor(img * scale - lo * scale), 0.0, 255.0)
        ac = torch.where(hi <= lo, img, ac)
        out = torch.where(k == _L_AC, ac, out)
    if want_eq:
        out = torch.where(k == _L_EQ, _equalize(img), out)
    return out


def _blend_degenerates(img, need_sharp, need_contrast, need_color):
    """The PIL ImageEnhance degenerate images, batched."""
    lum = None
    if need_contrast or need_color:
        lum = _grayscale_l(img)                          # [B, H, W]
    outs = {}
    if need_color:
        outs[_B_COLOR] = lum[..., None].expand_as(img)
    if need_contrast:
        mean = torch.floor(lum.mean(dim=(1, 2)) + 0.5)  # PIL int(mean + .5)
        outs[_B_CONTRAST] = mean[:, None, None, None].expand_as(img)
    if need_sharp:
        outs[_B_SHARP] = _smooth(img)
    return outs


def _apply_blend(img, kind, factor, degenerates):
    deg = torch.zeros_like(img)                          # brightness: black
    for bk, d in degenerates.items():
        deg = torch.where((kind == bk)[:, None, None, None], d, deg)
    f = factor[:, None, None, None]
    return torch.clamp(torch.floor(deg + f * (img - deg)), 0.0, 255.0)


def _slot_kinds(table):
    """The sets of kinds a table holds, to skip the paths none uses."""
    cls = table[:, 1].astype(int)
    kind = table[:, 2].astype(int)
    luts = set(kind[cls == _CLS_LUT].tolist())
    blends = set(kind[cls == _CLS_BLEND].tolist())
    geoms = set(kind[cls == _CLS_GEOM].tolist())
    return luts, blends, geoms


# ----------------------------------------------------------------------
# one op slot: draws, then their application
# ----------------------------------------------------------------------

def _row_args(rows, u_apply, u_sign, z, magnitude_std):
    """(apply, arg, cls, kind) per image from the slot's rows [B, 11] and
    its uniform (apply, sign) and normal (level jitter) draws."""
    prob, cls, kind = rows[:, 0], rows[:, 1], rows[:, 2]
    p1, cast = rows[:, 3], rows[:, 4]
    q0, q1, neg = rows[:, 5], rows[:, 6], rows[:, 7]
    qlo, qhi, level = rows[:, 8], rows[:, 9], rows[:, 10]
    if magnitude_std > 0:
        level = level + magnitude_std * z
    level = torch.clamp(level, 0.0, _MAX_LEVEL)
    m = level / _MAX_LEVEL
    inner = p1 * m
    f = torch.where(cast > 0, torch.floor(inner), inner)
    sgn = torch.where(u_sign < 0.5, -1.0, 1.0)
    sgn = torch.where(neg > 0, sgn, 1.0)
    arg = torch.clamp(q0 + q1 * sgn * f, qlo, qhi)
    # the host AugmentOp skips an op iff prob < 1 and random() > prob
    return u_apply <= prob, arg, cls, kind


def _row_draws(rows, generator, magnitude_std):
    bsz, device = rows.shape[0], rows.device
    u_apply = torch.rand(bsz, generator=generator, device=device)
    u_sign = torch.rand(bsz, generator=generator, device=device)
    z = torch.randn(bsz, generator=generator, device=device)
    return _row_args(rows, u_apply, u_sign, z, magnitude_std)


def _apply_nongeom(img, apply, arg, cls, kind, table_static):
    """The LUT- and blend-class ops of one slot; geometric-class images
    pass through."""
    luts, blends, _ = table_static
    out = img
    if luts:
        out = torch.where((cls == _CLS_LUT)[:, None, None, None],
                          _apply_point_ops(img, kind, arg, _L_EQ in luts,
                                           _L_AC in luts), out)
    if blends:
        degs = _blend_degenerates(img, _B_SHARP in blends,
                                  _B_CONTRAST in blends, _B_COLOR in blends)
        out = torch.where((cls == _CLS_BLEND)[:, None, None, None],
                          _apply_blend(img, kind, arg, degs), out)
    return torch.where(apply[:, None, None, None], out, img)


def _apply_slot(img, draws, table_static):
    """One op slot's draws (apply, arg, cls, kind) applied to ``img``."""
    apply, arg, cls, kind = draws
    luts, blends, geoms = table_static
    out = _apply_nongeom(img, torch.ones_like(apply), arg, cls, kind,
                         table_static)
    if geoms:
        mats = _geom_matrices(kind, arg, img.shape[1], img.shape[2])
        out = torch.where((cls == _CLS_GEOM)[:, None, None, None],
                          _affine_warp(img, mats), out)
    return torch.where(apply[:, None, None, None], out, img)


def apply_op(img, name, arg):
    """Op ``name`` at argument ``arg`` on every image of ``img`` [B, H, W,
    3] (f32, the uint8 lattice): the host ``AugmentOp``'s op."""
    cls, kind = _op_spec(name)[:2]
    bsz = img.shape[0]
    static = (({kind} if cls == _CLS_LUT else set()),
              ({kind} if cls == _CLS_BLEND else set()),
              ({kind} if cls == _CLS_GEOM else set()))
    row = torch.tensor([float(arg), cls, kind], device=img.device)
    draws = (torch.ones(bsz, dtype=torch.bool, device=img.device),
             *row.expand(bsz, 3).unbind(1))
    return _apply_slot(_quantize(img), draws, static)


# ----------------------------------------------------------------------
# policy classes
# ----------------------------------------------------------------------

class DeviceAutoAugment:
    """AutoAugment on a batch, the host class's policy tables: one
    sub-policy drawn per image, its two slots applied in order."""

    def __init__(self, policy: str = "v0", magnitude_std: float = 0.0):
        table = _POLICIES[policy]
        rows = np.asarray([[_row(*op) for op in sub] for sub in table],
                          np.float32)                    # [25, 2, 11]
        self.table = np.ascontiguousarray(np.swapaxes(rows, 0, 1))
        self._static = _slot_kinds(rows.reshape(-1, _ROW_LEN))
        self._static_slot = tuple(_slot_kinds(rows[:, s, :])
                                  for s in range(rows.shape[1]))
        # one warp for both slots where no sub-policy has geometric ops in
        # both ('original', 'originalr'); 'v0' and 'v0r' have two such
        # sub-policies and warp per slot
        geom_count = (rows[:, :, 1] == _CLS_GEOM).sum(axis=1)
        any_geom = bool((geom_count > 0).any())
        self._single_warp = any_geom and not bool((geom_count >= 2).any())
        self.magnitude_std = float(magnitude_std)
        self.n_sub = rows.shape[0]

    def draw(self, bsz, generator, device):
        """{"slots": [(apply, arg, cls, kind) for each slot]}: a sub-policy
        index per image, then each slot's draws."""
        idx = torch.randint(0, self.n_sub, (bsz,), generator=generator,
                            device=device)
        table = torch.as_tensor(self.table, device=device)
        return {"slots": [_row_draws(table[s][idx], generator,
                                     self.magnitude_std)
                          for s in range(table.shape[0])]}

    def apply(self, img, draws):
        img = _quantize(img)
        d0, d1 = draws["slots"]
        if not self._single_warp:
            img = _apply_slot(img, d0, self._static)
            return _apply_slot(img, d1, self._static)
        # each image has at most one live geometric op: the slot-0 colour
        # ops, the warp, then the slot-1 colour ops, in the per-slot order
        ap0, arg0, cls0, k0 = d0
        ap1, arg1, cls1, k1 = d1
        h, w = img.shape[1], img.shape[2]
        img = _apply_nongeom(img, *d0, self._static_slot[0])
        g0 = ap0 & (cls0 == _CLS_GEOM)
        g1 = ap1 & (cls1 == _CLS_GEOM)
        mats = _geom_matrices(torch.where(g0, k0, k1),
                              torch.where(g0, arg0, arg1), h, w)
        img = torch.where((g0 | g1)[:, None, None, None],
                          _affine_warp(img, mats), img)
        return _apply_nongeom(img, *d1, self._static_slot[1])

    def __call__(self, img, generator):
        return self.apply(img, self.draw(img.shape[0], generator,
                                         img.device))


class DeviceRandAugment:
    """RandAugment(N, M) on a batch: N ops drawn uniformly (with
    replacement) per image, each applied with probability ``prob``."""

    def __init__(self, N: int = 2, M: float = 9.0, prob: float = 0.5,
                 magnitude_std: float = 0.5, increasing: bool = True):
        names = (_RAND_INCREASING_TRANSFORMS if increasing
                 else _RAND_TRANSFORMS)
        rows = np.asarray([_row(n, prob, M) for n in names], np.float32)
        self.table = rows                                # [n_ops, 11]
        self._static = _slot_kinds(rows)
        self.N = int(N)
        self.magnitude_std = float(magnitude_std)
        self.n_ops = rows.shape[0]

    def draw(self, bsz, generator, device):
        table = torch.as_tensor(self.table, device=device)
        slots = []
        for _ in range(self.N):
            idx = torch.randint(0, self.n_ops, (bsz,), generator=generator,
                                device=device)
            slots.append(_row_draws(table[idx], generator,
                                    self.magnitude_std))
        return {"slots": slots}

    def apply(self, img, draws):
        img = _quantize(img)
        for slot in draws["slots"]:
            img = _apply_slot(img, slot, self._static)
        return img

    def __call__(self, img, generator):
        return self.apply(img, self.draw(img.shape[0], generator,
                                         img.device))


class DeviceNormalize:
    """image / 255 (the host ``Normalize``)."""

    def __call__(self, img, generator=None):
        return img / 255.0


class DeviceRandomErasing:
    """timm-style random erasing in 'pixel' mode after normalisation:
    N(0, 1) fill, 10 candidate (area, aspect) draws per image, the first
    that fits wins."""

    def __init__(self, prob=0.5, area_range=(0.02, 1. / 3.),
                 min_aspect_ratio=0.3, tries: int = 10):
        self.prob = float(prob)
        self.area_range = tuple(area_range)
        self.log_aspect = (math.log(min_aspect_ratio),
                           math.log(1.0 / min_aspect_ratio))
        self.tries = int(tries)

    def draw(self, shape, generator, device):
        """Uniform draws ``on``, ``y``, ``x`` [B]; ``area`` [B, tries] in
        ``area_range`` (a share of the image); ``log_aspect`` [B, tries];
        ``fill`` N(0, 1) of the batch's shape."""
        bsz = shape[0]

        def uniform(size, lo=0.0, hi=1.0):
            u = torch.rand(size, generator=generator, device=device)
            return lo + (hi - lo) * u

        t = self.tries
        return {"on": uniform(bsz), "area": uniform((bsz, t),
                                                    *self.area_range),
                "log_aspect": uniform((bsz, t), *self.log_aspect),
                "y": uniform(bsz), "x": uniform(bsz),
                "fill": torch.randn(shape, generator=generator,
                                    device=device)}

    def apply(self, img, draws):
        bsz, h, w, _ = img.shape
        target = draws["area"] * (h * w)
        aspect = torch.exp(draws["log_aspect"])
        eh = torch.round(torch.sqrt(target * aspect))
        ew = torch.round(torch.sqrt(target / aspect))
        valid = (eh < h) & (ew < w)
        pick = torch.argmax(valid.to(torch.int32), dim=1)  # first that fits
        ehp = eh.gather(1, pick[:, None])[:, 0]
        ewp = ew.gather(1, pick[:, None])[:, 0]
        y0 = torch.floor(draws["y"] * (h - ehp))
        x0 = torch.floor(draws["x"] * (w - ewp))
        ys = torch.arange(h, dtype=torch.float32,
                          device=img.device)[None, :, None]
        xs = torch.arange(w, dtype=torch.float32,
                          device=img.device)[None, None, :]
        box = ((ys >= y0[:, None, None]) & (ys < (y0 + ehp)[:, None, None])
               & (xs >= x0[:, None, None])
               & (xs < (x0 + ewp)[:, None, None]))
        on = (draws["on"] <= self.prob) & valid.any(dim=1)
        mask = box & on[:, None, None]
        return torch.where(mask[..., None], draws["fill"].to(img.dtype), img)

    def __call__(self, img, generator):
        return self.apply(img, self.draw(img.shape, generator, img.device))


def _beta_pair(generator, a_mix, a_cut):
    """(lambda_mixup, lambda_cutmix) drawn on the host by numpy's Beta from
    a PCG64 seeded by the step generator's seed."""
    rng = np.random.Generator(np.random.PCG64(
        [generator.initial_seed(), 0x6D697875]))
    return float(rng.beta(a_mix, a_mix)), float(rng.beta(a_cut, a_cut))


class DeviceMixupCutmix:
    """Batch-mode mixup/cutmix with soft one-hot labels: the partner is the
    flipped batch, one lambda and one box a batch, cutmix's lambda
    corrected by the box's realised area."""

    def __init__(self, use_mixup=True, mixup_alpha=0.8, cutmix_alpha=1.0,
                 mixup_cutmix_prob=1.0, switch_to_cutmix_prob=0.5,
                 label_smoothing=0.1, num_classes=1000):
        self.use_mixup = bool(use_mixup)
        self.mixup_alpha = float(mixup_alpha)
        self.cutmix_alpha = float(cutmix_alpha)
        self.prob = float(mixup_cutmix_prob)
        self.switch = float(switch_to_cutmix_prob)
        self.smoothing = float(label_smoothing)
        self.num_classes = int(num_classes)

    def draw(self, generator, device):
        """Uniform 0-d draws ``on``, ``switch``, ``cy``, ``cx`` on the
        device and the host's ``lam_mix``, ``lam_cut``."""
        u = torch.rand(4, generator=generator, device=device)
        lam_mix, lam_cut = _beta_pair(generator, self.mixup_alpha,
                                      self.cutmix_alpha)
        return {"on": u[0], "switch": u[1], "lam_mix": lam_mix,
                "lam_cut": lam_cut, "cy": u[2], "cx": u[3]}

    def _one_hot(self, labels, on, off):
        oh = F.one_hot(labels.long(), self.num_classes).float()
        return oh * (on - off) + off

    def apply(self, img, labels, draws):
        off = self.smoothing / self.num_classes
        on = 1.0 - self.smoothing + off
        y1 = self._one_hot(labels, on, off)
        if not self.use_mixup:
            return img, y1
        y2 = self._one_hot(labels.flip(0), on, off)
        enabled = draws["on"] < self.prob
        use_cutmix = draws["switch"] < self.switch
        lam_m = torch.as_tensor(draws["lam_mix"], dtype=torch.float32,
                                device=img.device)
        lam_c = torch.as_tensor(draws["lam_cut"], dtype=torch.float32,
                                device=img.device)
        h, w = img.shape[1], img.shape[2]
        ratio = torch.sqrt(1.0 - lam_c)
        cut_h = torch.floor(h * ratio)
        cut_w = torch.floor(w * ratio)
        cy = torch.floor(draws["cy"] * h)
        cx = torch.floor(draws["cx"] * w)
        yl = torch.clamp(cy - torch.floor(cut_h / 2), 0, h)
        yh = torch.clamp(cy + torch.floor(cut_h / 2), 0, h)
        xl = torch.clamp(cx - torch.floor(cut_w / 2), 0, w)
        xh = torch.clamp(cx + torch.floor(cut_w / 2), 0, w)
        # correct_lam: the box's realised area
        lam_c_eff = 1.0 - (yh - yl) * (xh - xl) / float(h * w)
        ys = torch.arange(h, dtype=torch.float32,
                          device=img.device)[None, :, None, None]
        xs = torch.arange(w, dtype=torch.float32,
                          device=img.device)[None, None, :, None]
        box = (ys >= yl) & (ys < yh) & (xs >= xl) & (xs < xh)
        flipped = img.flip(0)
        img_cut = torch.where(box, flipped, img)
        img_mix = img * lam_m + flipped * (1.0 - lam_m)
        lam = torch.where(use_cutmix, lam_c_eff, lam_m)
        lam = torch.where(enabled, lam, 1.0)
        out_img = torch.where(enabled,
                              torch.where(use_cutmix, img_cut, img_mix), img)
        return out_img, y1 * lam + y2 * (1.0 - lam)

    def __call__(self, img, labels, generator):
        return self.apply(img, labels, self.draw(generator, img.device))


class DeviceAugmentPipeline:
    """The engine's ``augment_fn``: ``(batch, generator) -> batch`` on the
    card. Stages in the host pipeline's order: augment (uint8 lattice) ->
    normalize -> erasing -> mixup/cutmix (labels become soft one-hot)."""

    def __init__(self, augment=None, normalize=True, erasing=None,
                 mixupcutmix=None):
        self.augment = augment
        self.normalize = DeviceNormalize() if normalize else None
        self.erasing = erasing
        self.mixupcutmix = mixupcutmix

    def draw(self, batch, generator):
        img = batch["image"]
        return {
            "augment": None if self.augment is None else self.augment.draw(
                img.shape[0], generator, img.device),
            "erasing": None if self.erasing is None else self.erasing.draw(
                img.shape, generator, img.device),
            "mixupcutmix": None if self.mixupcutmix is None else
            self.mixupcutmix.draw(generator, img.device)}

    def apply(self, batch, draws):
        img = batch["image"].float()
        if self.augment is not None:
            img = self.augment.apply(img, draws["augment"])
        if self.normalize is not None:
            img = self.normalize(img)
        if self.erasing is not None:
            img = self.erasing.apply(img, draws["erasing"])
        out = dict(batch)
        if self.mixupcutmix is not None:
            img, y = self.mixupcutmix.apply(img, batch["label"],
                                            draws["mixupcutmix"])
            out["label"] = y
        out["image"] = img
        return out

    def __call__(self, batch, generator):
        return self.apply(batch, self.draw(batch, generator))
