"""The port's augmentation (``simpleaicv_tpu_torch/data/device_augment.py``,
``data/auto_rand_augment.py``, ``data/mixupcutmix.py``) against the JAX
package's device ops and PIL, on the CPU.

Both packages' device ops take the same draws: each test takes them from
the JAX functions (``_row_draws`` and the draws inside the policy classes,
erasing and mixup/cutmix, on the JAX rng splits) and feeds them to the
port's ``apply``. Bounds, as ``tests/test_device_augment.py`` states them
for the JAX ops against PIL:

* the geometric, table and Equalize ops are exact, against JAX and PIL,
  except Rotate: its f32 ``cos``/``sin`` (torch's against XLA's) may part
  by an ulp, which moves a 16.16 fixed-point coefficient in a few percent
  of the rotations and then a few pixels
  (``test_rotate_parts_from_jax_in_few_pixels`` measures it); the tests
  allow 32 pixels per rotated image, and none in any other op;
* the enhance blends and AutoContrast within one level (PIL's own f32
  rounding, and the order of a sum or a convolution);
* a whole policy (AutoAugment v0 and original, RandAugment) on random
  draws: no pixel off by more than one level outside the rotated images'
  bound, and at most 0.5% of the pixels off at all (a level moved by a
  blend carries through a later table op);
* erasing and mixup/cutmix to 1e-6;
* the host ``AutoAugment``/``RandAugment`` against the JAX package's PIL
  classes under one ``random`` seed, to the same split;
* ``MixupCutmixClassificationCollater`` against the JAX collater under one
  ``np.random`` seed, exactly.
"""

from pathlib import Path
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.data import auto_rand_augment as jax_host
from simpleaicv_tpu.data import device_augment as jdev
from simpleaicv_tpu.data import mixupcutmix as jax_mix
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.data import auto_rand_augment as host
from simpleaicv_tpu_torch.data import device_augment as dev
from simpleaicv_tpu_torch.data import mixupcutmix
from simpleaicv_tpu_torch.losses.classification import OneHotLabelCELoss
from simpleaicv_tpu_torch.models.common import Linear, init_params
from simpleaicv_tpu_torch.tasks import classification as port_task

from _torch_port import one_torch_thread

REPO = Path(__file__).resolve().parent.parent
RECIPE = (REPO / "experiments/0.classification_training/fake_synthetic/"
          "resnet18_deviceaug")
B, H, W = 4, 24, 19
ROTATED_PX = 32  # pixels a rotated image may move (see the docstring)

STATIC_ALL = ({jdev._L_INV, jdev._L_SOL, jdev._L_SOLADD, jdev._L_POST,
               jdev._L_EQ, jdev._L_AC},
              {jdev._B_BRIGHT, jdev._B_COLOR, jdev._B_CONTRAST,
               jdev._B_SHARP},
              {jdev._G_SHEARX, jdev._G_SHEARY, jdev._G_TXABS, jdev._G_TYABS,
               jdev._G_TXREL, jdev._G_TYREL, jdev._G_ROT})

EXACT_OPS = [
    ("ShearX", 7.0), ("ShearY", 4.0), ("TranslateXRel", 6.0),
    ("TranslateYRel", 9.0), ("TranslateX", 0.3), ("Rotate", 8.0),
    ("Rotate", 2.0), ("Invert", 0.0), ("Solarize", 3.0), ("Solarize", 10.0),
    ("SolarizeIncreasing", 4.0), ("SolarizeAdd", 7.0), ("Posterize", 6.0),
    ("Posterize", 0.0), ("PosterizeIncreasing", 2.0),
    ("PosterizeOriginal", 5.0), ("Equalize", 0.0),
]
LSB_OPS = [
    ("AutoContrast", 0.0), ("Brightness", 3.0), ("Brightness", 9.0),
    ("Color", 2.0), ("Color", 8.0), ("Contrast", 5.0),
    ("Sharpness", 4.0), ("Sharpness", 10.0),
    ("ColorIncreasing", 7.0), ("ContrastIncreasing", 3.0),
    ("BrightnessIncreasing", 8.0), ("SharpnessIncreasing", 6.0),
]


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _imgs(seed=0, b=B, h=H, w=W):
    return np.random.RandomState(seed).randint(
        0, 256, (b, h, w, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_rows(name, level, b=B):
    """Rows of one op at probability 1 with the negation off."""
    row = np.asarray(jdev._row(name, 1.0, level), np.float32)
    rows = np.tile(row[None], (b, 1))
    rows[:, 7] = 0.0
    return jnp.asarray(rows)


def _jax_slot_draws(rows, key, std=0.0):
    return tuple(_t(a) for a in jdev._row_draws(rows, key, std))


def _op_both(imgs, name, level):
    rows = _jax_rows(name, level)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jdev._apply_rows(jnp.asarray(imgs), rows, key,
                                       STATIC_ALL, 0.0))
    got = dev._apply_slot(dev._quantize(_t(imgs)),
                          _jax_slot_draws(rows, key), STATIC_ALL).numpy()
    return got, want


def _pil_op(imgs, name, level):
    from PIL import Image
    arg = abs(jax_host._level_to_arg(name, level))
    if name.endswith("Increasing") and name[:-10] in (
            "Color", "Contrast", "Brightness", "Sharpness"):
        arg = max(0.1, 1.0 + 0.9 * level / 10.0)
    return np.stack([np.asarray(jax_host._OP_FNS[name](
        Image.fromarray(im.astype(np.uint8)), arg), np.float32)
        for im in imgs])


def _rotated_ok(got, want, rotated):
    """Pixels that differ: none outside the rotated images, at most
    ROTATED_PX in each rotated one."""
    moved = (got != want).any(axis=-1).sum(axis=(1, 2))
    assert (moved[~rotated] == 0).all(), moved
    assert (moved[rotated] <= ROTATED_PX).all(), moved


@pytest.mark.parametrize("name,level", EXACT_OPS,
                         ids=[f"{n}-{v}" for n, v in EXACT_OPS])
def test_exact_op_against_jax_and_pil(name, level):
    imgs = _imgs(len(name) + int(level))
    got, want = _op_both(imgs, name, level)
    if name == "Rotate":
        _rotated_ok(got, want, np.ones(B, bool))
    else:
        np.testing.assert_array_equal(got, want)
    pil = _pil_op(imgs, name, level)
    if name == "Rotate":
        _rotated_ok(got, pil, np.ones(B, bool))
    else:
        np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("name,level", LSB_OPS,
                         ids=[f"{n}-{v}" for n, v in LSB_OPS])
def test_one_lsb_op_against_jax_and_pil(name, level):
    imgs = _imgs(len(name) + int(level) + 1)
    got, want = _op_both(imgs, name, level)
    assert np.abs(got - want).max() <= 1.0
    assert np.abs(got - _pil_op(imgs, name, level)).max() <= 1.0


@pytest.mark.parametrize("case", ["constant", "two_values", "one_channel",
                                  "full_range"])
def test_equalize_and_autocontrast_degenerate_channels(case):
    """Equalize exactly and AutoContrast within one level, against JAX and
    PIL, on channels with one value, two values, one constant channel
    among varied ones, and the full range."""
    imgs = _imgs(11)
    if case == "constant":
        imgs[:] = 77.0
    elif case == "two_values":
        imgs = np.where(imgs > 128, 200.0, 13.0).astype(np.float32)
    elif case == "one_channel":
        imgs[..., 1] = 5.0
    else:
        imgs[:, 0, 0] = 0.0
        imgs[:, 0, 1] = 255.0
    for name, tol in (("Equalize", 0.0), ("AutoContrast", 1.0)):
        got, want = _op_both(imgs, name, 0.0)
        assert np.abs(got - want).max() <= tol, name
        assert np.abs(got - _pil_op(imgs, name, 0.0)).max() <= tol, name


def test_histogram_counts_exactly():
    imgs = _imgs(12, b=3, h=40, w=33)
    values = dev._channel_values(_t(imgs))
    hist = dev._histogram(values).numpy()
    for i in range(3):
        for c in range(3):
            want = np.bincount(imgs[i, ..., c].astype(np.int64).ravel(),
                               minlength=256)
            np.testing.assert_array_equal(hist[i, c], want)


@pytest.mark.parametrize("h,w", [(32, 32), (57, 41)])
def test_warp_against_the_jax_gather_for_every_geometric_op(h, w):
    """Random arguments over each op's range: the matrices' fixed-point
    warp against JAX ``_affine_warp_gather``; exact but for Rotate."""
    rng = np.random.RandomState(h)
    kinds = np.asarray([jdev._G_ROT, jdev._G_SHEARX, jdev._G_SHEARY,
                        jdev._G_TXREL, jdev._G_TYREL, jdev._G_TXABS,
                        jdev._G_TYABS, jdev._G_ROT], np.float32)
    lims = [30, 0.3, 0.3, 0.45, 0.45, 12, 12, 30]
    for _ in range(6):
        img = rng.randint(0, 256, (len(kinds), h, w, 3)).astype(np.float32)
        arg = np.asarray([rng.uniform(-m, m) for m in lims], np.float32)
        jm = jdev._geom_matrices(jnp.asarray(kinds), jnp.asarray(arg), h, w)
        want = np.asarray(jdev._affine_warp_gather(jnp.asarray(img), jm))
        pm = dev._geom_matrices(_t(kinds), _t(arg), h, w)
        got = dev._affine_warp(_t(img), pm).numpy()
        _rotated_ok(got, want, kinds == jdev._G_ROT)
        # on JAX's own matrices the warp is exact
        np.testing.assert_array_equal(
            dev._affine_warp(_t(img), _t(jm)).numpy(), want)


def _fixed_point(mat):
    """PIL's six 16.16 coefficients of each inverse map [N, 6] (f32), as
    ``_warp_indices`` forms them, in int64."""
    f = np.float32

    def fix(v):
        return np.floor(v * f(65536) + f(0.5)).astype(np.int64)

    a, b, c, d, e, g = (mat[:, i] for i in range(6))
    return np.stack([fix(a * f(.5) + b * f(.5) + c),
                     fix(d * f(.5) + e * f(.5) + g), fix(a), fix(b), fix(d),
                     fix(e)], axis=1)


def rotate_disagreement(h, w, n_angles, n_images, seed=1):
    """Rotate's matrices from torch's and XLA's f32 cos/sin over
    ``n_angles`` random angles in [-30, 30]: (angles whose fixed-point
    coefficients differ, the largest difference in a coefficient, the
    pixels moved in each of up to ``n_images`` such rotations)."""
    rng = np.random.RandomState(seed)
    kind = np.full(n_angles, jdev._G_ROT, np.float32)
    arg = rng.uniform(-30, 30, n_angles).astype(np.float32)
    jm = np.asarray(jdev._geom_matrices(jnp.asarray(kind), jnp.asarray(arg),
                                        h, w))
    pm = dev._geom_matrices(_t(kind), _t(arg), h, w).numpy()
    fj, fp = _fixed_point(jm), _fixed_point(pm)
    differ = np.nonzero((fj != fp).any(axis=1))[0]
    pick = differ[:n_images]
    img = rng.randint(0, 256, (len(pick), h, w, 3)).astype(np.float32)
    want = np.asarray(jdev._affine_warp_gather(jnp.asarray(img),
                                               jnp.asarray(jm[pick])))
    got = dev._affine_warp(_t(img), _t(pm[pick])).numpy()
    moved = (got != want).any(axis=-1).sum(axis=(1, 2))
    return len(differ), int(np.abs(fj - fp).max()), moved


@pytest.mark.parametrize("h,w", [(224, 224), (24, 19)])
def test_rotate_parts_from_jax_in_few_pixels(h, w):
    """The bound the other tests allow a rotated image, measured: over
    20,000 angles the coefficients differ in under 10% of the rotations,
    by at most 2 units of 2^-16, and 16 such rotations move at most
    ROTATED_PX pixels each."""
    n_differ, worst, moved = rotate_disagreement(h, w, 20000, 16)
    assert n_differ < 2000 and worst <= 2, (n_differ, worst)
    assert (moved <= ROTATED_PX).all(), moved


def test_warp_shift_is_arithmetic_on_negative_coordinates():
    """Translating past the left and top edges: source coordinates below 0
    take the fill, as PIL's (an unsigned shift would wrap them inside)."""
    img = _imgs(13, b=2, h=16, w=16)
    mat = torch.tensor([[1, 0, -5.0, 0, 1, -3.0], [1, 0, -20.0, 0, 1, 0]])
    out = dev._affine_warp(_t(img), mat).numpy()
    assert (out[0, :3] == 128).all() and (out[0, :, :5] == 128).all()
    np.testing.assert_array_equal(out[0, 3:, 5:], img[0, :-3, :-5])
    assert (out[1] == 128).all()


def _policy_outputs_agree(got, want, rotated):
    """Policy outputs: pixels off by more than a level only in the rotated
    images, and at most 0.5% of all pixels off at all."""
    diff = np.abs(got - want)
    far = (diff > 1.0).any(axis=-1).sum(axis=(1, 2))
    assert (far[~rotated] == 0).all(), far
    off = (diff > 0).any(axis=-1).mean()
    assert off <= 5e-3, off


def _rotated(draws):
    out = np.zeros(len(draws[0][0]), bool)
    for apply, arg, cls, kind in draws:
        out |= (apply.numpy() & (cls.numpy() == jdev._CLS_GEOM)
                & (kind.numpy() == jdev._G_ROT))
    return out


@pytest.mark.parametrize("policy", ["v0", "original"])
def test_auto_augment_with_the_jax_draws(policy):
    imgs = _imgs(14, b=16, h=32, w=32)
    aug = jdev.DeviceAutoAugment(policy)
    port = dev.DeviceAutoAugment(policy)
    assert port._single_warp == aug._single_warp
    for seed in (0, 1):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(aug(jnp.asarray(imgs), rng))
        r_idx, r0, r1 = jax.random.split(rng, 3)
        idx = jax.random.randint(r_idx, (16,), 0, aug.n_sub)
        draws = [_jax_slot_draws(jnp.take(aug.table[s], idx, axis=0), r)
                 for s, r in ((0, r0), (1, r1))]
        got = port.apply(_t(imgs), {"slots": draws}).numpy()
        _policy_outputs_agree(got, want, _rotated(draws))


@pytest.mark.parametrize("increasing", [True, False])
def test_rand_augment_with_the_jax_draws(increasing):
    imgs = _imgs(15, b=16, h=32, w=32)
    aug = jdev.DeviceRandAugment(N=2, M=9, increasing=increasing)
    port = dev.DeviceRandAugment(N=2, M=9, increasing=increasing)
    np.testing.assert_array_equal(port.table, np.asarray(aug.table))
    rng = jax.random.PRNGKey(3)
    want = np.asarray(aug(jnp.asarray(imgs), rng))
    draws, r = [], rng
    for i in range(2):
        r_i, r_op, r = jax.random.split(jax.random.fold_in(r, i), 3)
        idx = jax.random.randint(r_i, (16,), 0, aug.n_ops)
        draws.append(_jax_slot_draws(jnp.take(aug.table, idx, axis=0), r_op,
                                     aug.magnitude_std))
    got = port.apply(_t(imgs), {"slots": draws}).numpy()
    _policy_outputs_agree(got, want, _rotated(draws))


def test_row_arguments_match_the_jax_row_draws():
    """The level -> argument formula (jitter, negation, cast, clip) on the
    JAX rng's own uniforms and normals, for every RandAugment op."""
    aug = jdev.DeviceRandAugment(N=1, M=7, magnitude_std=0.5)
    rows = jnp.tile(aug.table, (20, 1))
    key = jax.random.PRNGKey(4)
    r_apply, r_sign, r_std = jax.random.split(key, 3)
    n = rows.shape[0]
    want = jdev._row_draws(rows, key, 0.5)
    got = dev._row_args(_t(rows), _t(jax.random.uniform(r_apply, (n,))),
                        _t(jax.random.uniform(r_sign, (n,))),
                        _t(jax.random.normal(r_std, (n,))), 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_erasing_draws(er, shape, rng):
    r_on, r_a, r_ar, r_y, r_x, r_fill = jax.random.split(rng, 6)
    b, t = shape[0], er.tries
    return {"on": _t(jax.random.uniform(r_on, (b,))),
            "area": _t(jax.random.uniform(r_a, (b, t),
                                          minval=er.area_range[0],
                                          maxval=er.area_range[1])),
            "log_aspect": _t(jax.random.uniform(r_ar, (b, t),
                                                minval=er.log_aspect[0],
                                                maxval=er.log_aspect[1])),
            "y": _t(jax.random.uniform(r_y, (b,))),
            "x": _t(jax.random.uniform(r_x, (b,))),
            "fill": _t(jax.random.normal(r_fill, shape, jnp.float32))}


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_random_erasing_with_the_jax_draws(prob):
    imgs = _imgs(16, b=8, h=32, w=32) / 255.0
    er = jdev.DeviceRandomErasing(prob=prob)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(er(jnp.asarray(imgs), rng))
    got = dev.DeviceRandomErasing(prob=prob).apply(
        _t(imgs), _jax_erasing_draws(er, imgs.shape, rng)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    if prob == 1.0:
        assert ((got != imgs).any(axis=(1, 2, 3))).all()


def _jax_mix_draws(mix, rng):
    r_on, r_sw, r_lam_m, r_lam_c, r_cy, r_cx = jax.random.split(rng, 6)
    return {"on": _t(jax.random.uniform(r_on, ())),
            "switch": _t(jax.random.uniform(r_sw, ())),
            "lam_mix": float(jax.random.beta(r_lam_m, mix.mixup_alpha,
                                             mix.mixup_alpha)),
            "lam_cut": float(jax.random.beta(r_lam_c, mix.cutmix_alpha,
                                             mix.cutmix_alpha)),
            "cy": _t(jax.random.uniform(r_cy, ())),
            "cx": _t(jax.random.uniform(r_cx, ()))}


@pytest.mark.parametrize("switch", [0.0, 1.0, 0.5])
def test_mixup_cutmix_with_the_jax_draws(switch):
    imgs = _imgs(17, b=6, h=32, w=32) / 255.0
    labels = np.arange(6) % 10
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0,
              switch_to_cutmix_prob=switch, label_smoothing=0.1,
              num_classes=10)
    mix = jdev.DeviceMixupCutmix(**kw)
    for seed in range(4):
        rng = jax.random.PRNGKey(seed)
        wi, wy = mix(jnp.asarray(imgs), jnp.asarray(labels), rng)
        gi, gy = dev.DeviceMixupCutmix(**kw).apply(
            _t(imgs), _t(labels), _jax_mix_draws(mix, rng))
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-6)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-6)


def test_pipeline_with_the_jax_draws_on_uint8():
    """RandAugment -> normalize -> erasing -> mixup/cutmix on a uint8
    batch, every stage on the JAX draws of the JAX pipeline's splits."""
    b = 8
    imgs = _imgs(18, b=b, h=32, w=32).astype(np.uint8)
    labels = np.arange(b) % 10
    jp = jdev.DeviceAugmentPipeline(
        augment=jdev.DeviceRandAugment(N=2, M=9),
        erasing=jdev.DeviceRandomErasing(prob=0.5),
        mixupcutmix=jdev.DeviceMixupCutmix(num_classes=10))
    pp = dev.DeviceAugmentPipeline(
        augment=dev.DeviceRandAugment(N=2, M=9),
        erasing=dev.DeviceRandomErasing(prob=0.5),
        mixupcutmix=dev.DeviceMixupCutmix(num_classes=10))
    rng = jax.random.PRNGKey(6)
    want = jp({"image": jnp.asarray(imgs), "label": jnp.asarray(labels)},
              rng)
    r_aug, r_er, r_mix = jax.random.split(rng, 3)
    slots, r = [], r_aug
    for i in range(2):
        r_i, r_op, r = jax.random.split(jax.random.fold_in(r, i), 3)
        idx = jax.random.randint(r_i, (b,), 0, jp.augment.n_ops)
        slots.append(_jax_slot_draws(jnp.take(jp.augment.table, idx, axis=0),
                                     r_op, jp.augment.magnitude_std))
    draws = {"augment": {"slots": slots},
             "erasing": _jax_erasing_draws(jp.erasing, imgs.shape, r_er),
             "mixupcutmix": _jax_mix_draws(jp.mixupcutmix, r_mix)}
    got = pp.apply({"image": _t(imgs), "label": _t(labels)}, draws)
    np.testing.assert_allclose(got["label"].numpy(), np.asarray(
        want["label"]), atol=1e-6)
    # one level of the lattice is 1/255 after normalisation
    diff = np.abs(got["image"].numpy() - np.asarray(want["image"]))
    assert (diff > 1.5 / 255).any(axis=-1).sum(axis=(1, 2))[
        ~_rotated(slots)].max() == 0
    assert (diff > 1e-6).mean() <= 5e-3


def test_draws_distributions():
    """The port's own draws over a large batch: sub-policies and ops
    uniform, each op applied with its probability, geometric and increasing
    arguments negated half the time, the erasing area and aspect in range,
    lambda's Beta means and the step seed's effect."""
    g = torch.Generator().manual_seed(0)
    n = 20000
    aug = dev.DeviceAutoAugment("v0")
    d = aug.draw(n, g, "cpu")
    apply0, _, cls0, kind0 = d["slots"][0]
    # sub-policies drawn uniformly: the applied share is the mean of the
    # slot's probabilities, and each slot-0 op shows up at its rate
    prob0 = aug.table[0][:, 0]
    assert abs(apply0.float().mean().item() - prob0.mean()) < 0.02
    eq = ((cls0 == dev._CLS_LUT) & (kind0 == dev._L_EQ)).float().mean()
    want = np.mean([r[1] == dev._CLS_LUT and r[2] == dev._L_EQ
                    for r in aug.table[0]])
    assert abs(eq.item() - want) < 0.02
    ra = dev.DeviceRandAugment(N=2, M=9)
    d = ra.draw(n, g, "cpu")
    apply, arg, cls, kind = d["slots"][0]
    assert abs(apply.float().mean().item() - 0.5) < 0.02
    counts = torch.bincount(kind[cls == dev._CLS_GEOM].long())
    assert counts[dev._G_ROT] > 0
    rot = arg[(cls == dev._CLS_GEOM) & (kind == dev._G_ROT)]
    assert abs((rot < 0).float().mean().item() - 0.5) < 0.05
    assert rot.abs().max() <= 30.0
    er = dev.DeviceRandomErasing(prob=0.25)
    e = er.draw((n, 8, 8, 3), g, "cpu")
    assert e["area"].min() >= 0.02 and e["area"].max() <= 1 / 3
    assert e["log_aspect"].abs().max() <= abs(np.log(0.3)) + 1e-6
    assert abs(e["fill"].std().item() - 1.0) < 0.01
    mix = dev.DeviceMixupCutmix(mixup_alpha=0.8, cutmix_alpha=1.0)
    lams = np.asarray([dev._beta_pair(port_engine.step_generator(
        torch.Generator(), 0, s), 0.8, 1.0) for s in range(4000)])
    assert abs(lams[:, 0].mean() - 0.5) < 0.02
    assert abs(lams[:, 1].var() - 1 / 12) < 0.01  # Beta(1, 1) is uniform
    assert len(set(lams[:, 0].tolist())) == 4000
    d1 = mix.draw(port_engine.step_generator(torch.Generator(), 0, 7), "cpu")
    d2 = mix.draw(port_engine.step_generator(torch.Generator(), 0, 7), "cpu")
    assert d1["lam_mix"] == d2["lam_mix"] and float(d1["cx"]) == float(
        d2["cx"])


def test_pipeline_through_make_train_step():
    """The pipeline as the engine's ``augment_fn`` on a uint8 batch: soft
    labels reach the loss, the parameters move, and the same seed and step
    give the same update."""
    b, ncls = 8, 10

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(16 * 16 * 3, ncls)

        def forward(self, x, generator=None):
            return self.fc(x.reshape(x.shape[0], -1))

    def run():
        model = init_params(Tiny(), torch.Generator().manual_seed(0))
        opt, _ = port_optim.build_optimizer(
            port_optim.OptimizerConfig(name="SGD", lr=0.1),
            port_schedule.SchedulerConfig(scheduler="CosineLR", lr=0.1,
                                          epochs=1), 1, model, device="cpu")
        cfg = port_engine.EngineConfig()
        state = port_engine.create_train_state(model, opt, cfg, "cpu")
        seen = {}

        def loss(pred, label):
            seen["label"] = label
            return OneHotLabelCELoss()(pred, label)

        pipe = dev.DeviceAugmentPipeline(
            augment=dev.DeviceAutoAugment("v0"),
            erasing=dev.DeviceRandomErasing(prob=0.5),
            mixupcutmix=dev.DeviceMixupCutmix(num_classes=ncls))
        step = port_engine.make_train_step(port_task.make_loss_fn(loss), cfg,
                                           augment_fn=pipe)
        before = model.fc.weight.detach().clone()
        batch = {"image": _t(_imgs(19, b=b, h=16, w=16).astype(np.uint8)),
                 "label": _t(np.arange(b) % ncls)}
        _, metrics = step(state, batch, seed=3)
        assert seen["label"].shape == (b, ncls)
        assert np.isfinite(float(metrics["loss"]))
        return before, model.fc.weight.detach().clone()

    b0, a0 = run()
    _, a1 = run()
    assert (a0 - b0).abs().max() > 0
    assert torch.equal(a0, a1)


@pytest.mark.parametrize("policy", ["v0", "original"])
def test_host_auto_augment_against_pil(policy):
    """The host class on the CPU ops against the JAX package's PIL class,
    both drawing from the global ``random`` seeded alike."""
    imgs = _imgs(20, b=12, h=24, w=19)
    for i, im in enumerate(imgs):
        random.seed(100 + i)
        want = jax_host.AutoAugment(policy)({"image": im.copy()})["image"]
        random.seed(100 + i)
        got = host.AutoAugment(policy)({"image": im.copy()})["image"]
        assert got.dtype == np.float32 and got.shape == im.shape
        _host_agree(got, want)


def _host_agree(got, want):
    diff = np.abs(got - want)
    far = (diff > 1.0).any(axis=-1).sum()
    assert far <= ROTATED_PX, far
    assert (diff > 0).any(axis=-1).mean() <= 0.02


def test_host_rand_augment_against_pil():
    imgs = _imgs(21, b=12, h=24, w=19)
    for i, im in enumerate(imgs):
        random.seed(200 + i)
        want = jax_host.RandAugment(N=2, M=9)({"image": im.copy()})["image"]
        random.seed(200 + i)
        got = host.RandAugment(N=2, M=9)({"image": im.copy()})["image"]
        _host_agree(got, want)


@pytest.mark.parametrize("switch", [0.0, 1.0])
def test_mixup_collater_against_the_jax_collater(switch):
    samples = [{"image": _imgs(22 + i, b=1, h=16, w=16)[0], "label": i % 5}
               for i in range(6)]
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0,
              switch_to_cutmix_prob=switch, num_classes=5)
    for seed in range(3):
        np.random.seed(seed)
        want = jax_mix.MixupCutmixClassificationCollater(**kw)(samples)
        np.random.seed(seed)
        got = mixupcutmix.MixupCutmixClassificationCollater(**kw)(samples)
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[k], want[k])


def test_train_classification_on_fake_synthetic_resnet18_deviceaug(
        tmp_path, monkeypatch):
    """The experiment's config (resnet18, AutoAugment v0 + erasing +
    mixup/cutmix on the step's batch) at 32^2 on 32 train and 16 test
    samples, 2 epochs, through the train and test CLIs."""
    from simpleaicv_tpu_torch.tools import test_classification
    from simpleaicv_tpu_torch.tools import train_classification
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    src = (RECIPE / "train_config.py").read_text()
    for old, new in (("num_samples=512, image_hw=64",
                      "num_samples=32, image_hw=32"),
                     ("num_samples=128, image_hw=64",
                      "num_samples=16, image_hw=32"),
                     ("input_image_size = 64", "input_image_size = 32"),
                     ("batch_size = 64", "batch_size = 16"),
                     ("epochs = 5", "epochs = 2")):
        assert old in src
        src = src.replace(old, new)
    (tmp_path / "train_config.py").write_text(src)
    test = (RECIPE / "test_config.py").read_text()
    assert 'trained_model_path = ""' in test
    (tmp_path / "test_config.py").write_text(test.replace(
        'trained_model_path = ""', 'trained_model_path = os.path.join('
        'os.path.dirname(os.path.abspath(__file__)), "checkpoints", '
        '"best")'))
    best = train_classification.main(["--work-dir", str(tmp_path)])
    metrics = test_classification.main(["--work-dir", str(tmp_path)])
    assert (tmp_path / "checkpoints" / "best").exists()
    assert metrics["key_metric"] == pytest.approx(best, abs=1e-6)
