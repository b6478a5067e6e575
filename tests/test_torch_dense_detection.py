"""The port's dense-detection pieces against the JAX package's, in f32 on the
CPU: the five IoU types, the anchor and point generators, RetinaFPN and
the three heads on bridged weights, ``RetinaLoss``, ``FCOSLoss`` and
``RetinaFaceLoss`` (values, gradients and assignments, with ties, an
image without boxes and a batch without positives, and against the
goldens of ``tests/test_{fcos,retina}_loss_golden.py``), and the three
decoders (with tied scores and fewer candidates than ``max_object_num``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.losses.detection import FCOSLoss as JaxFCOSLoss
from simpleaicv_tpu.losses.detection import RetinaLoss as JaxRetinaLoss
from simpleaicv_tpu.models import face_detection as jax_face
from simpleaicv_tpu.models.detection import anchor as jax_anchor
from simpleaicv_tpu.models.detection import decode as jax_decode
from simpleaicv_tpu.models.detection import fpn as jax_fpn
from simpleaicv_tpu.models.detection import head as jax_head
from simpleaicv_tpu.ops.iou import iou_method as jax_iou
from simpleaicv_tpu_torch.core.weights import (export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.losses.detection import FCOSLoss, RetinaLoss
from simpleaicv_tpu_torch.models import face_detection
from simpleaicv_tpu_torch.models.detection import anchor, decode, fpn, head
from simpleaicv_tpu_torch.ops.iou import IOU_TYPES, iou_method

from _torch_port import flatten_tree, jax_f32, one_torch_thread, random_params
from test_fcos_loss_golden import ref_assign, ref_losses
from test_retina_loss_golden import ref_retina_loss

STRIDES = (8, 16, 32, 64, 128)
IMG = 128


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_tree_close(got, want, rel):
    """Every leaf of two nested trees within ``rel`` of the largest value
    over all leaves of ``want``."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        err = np.abs(got[path] - w).max()
        assert err <= rel * scale, (path, err, scale)


# ---- IoU --------------------------------------------------------------------

def _box_pairs(box_type, seed=2):
    """[2, 9, 4] pairs: random overlapping and disjoint ones, a zero-width
    box, a zero-area one and an identical pair."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, 9, 2).astype(np.float32) * 4
    wh = 0.2 + rng.rand(2, 9, 2).astype(np.float32) * 3
    a = np.concatenate([xy, xy + wh], -1)
    b = np.roll(a, 3, axis=1) * 0.9 + 0.1
    a[0, 0, 2] = a[0, 0, 0]            # zero width
    a[1, 4, 2:] = a[1, 4, :2]          # zero area
    b[0, 1] = a[0, 1]                  # identical boxes
    if box_type == "xywh":
        a = np.concatenate([(a[..., :2] + a[..., 2:]) / 2,
                            a[..., 2:] - a[..., :2]], -1)
        b = np.concatenate([(b[..., :2] + b[..., 2:]) / 2,
                            b[..., 2:] - b[..., :2]], -1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("box_type", ["xyxy", "xywh"])
@pytest.mark.parametrize("iou_type", IOU_TYPES)
def test_iou_matches_jax(iou_type, box_type):
    """Values on every pair, degenerate ones included, within 1e-6;
    gradients of a weighted sum with respect to both boxes within 1e-5 of
    their largest, on the pairs away from a clip's edge (at a zero width
    JAX's clip splits the gradient in two, torch's ``clamp`` passes it)."""
    a, b = _box_pairs(box_type)
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), iou_type,
                              box_type))
    got = iou_method(_t(a), _t(b), iou_type, box_type)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert np.isfinite(want).all()
    assert got[0, 1].item() == pytest.approx(1.0, abs=1e-6)

    a, b = a[:, 5:], b[:, 5:]
    w = np.random.RandomState(3).randn(*a.shape[:-1]).astype(np.float32)
    jg = jax.grad(lambda x, y: jnp.sum(jax_iou(x, y, iou_type, box_type) * w),
                  argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    (iou_method(ta, tb, iou_type, box_type) * _t(w)).sum().backward()
    for g, j in ((ta.grad, jg[0]), (tb.grad, jg[1])):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j,
                                   atol=1e-5 * np.abs(j).max())


def test_iou_rejects_unknown_types():
    a, b = _box_pairs("xyxy")
    with pytest.raises(ValueError, match="unknown iou_type"):
        iou_method(_t(a), _t(b), "XIoU")
    with pytest.raises(ValueError, match="unknown box_type"):
        iou_method(_t(a), _t(b), "IoU", "cxcy")


# ---- anchors and points -----------------------------------------------------

# [w, h] per level: square, then a non-square canvas
SIZES = ([[16, 16], [8, 8], [4, 4], [2, 2], [1, 1]],
         [[20, 12], [10, 6], [5, 3], [3, 2], [2, 1]])


@pytest.mark.parametrize("sizes", SIZES, ids=["square", "wide"])
def test_anchors_and_points_equal_jax(sizes):
    kwargs = dict(areas=((24, 24), (48, 48), (96, 96), (192, 192),
                         (384, 384)), ratios=(0.5, 1, 2, 3),
                  scales=(1.0, 1.5))
    for args in ({}, kwargs):
        want = jax_anchor.RetinaAnchors(**args).flat_anchors(sizes)
        got = anchor.RetinaAnchors(**args).flat_anchors(sizes)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for g, w in zip(anchor.FCOSPositions().flat_positions_strides(sizes),
                    jax_anchor.FCOSPositions().flat_positions_strides(sizes)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    want = jax_face.RetinaFaceAnchors().flat_anchors(sizes[:3])
    got = face_detection.RetinaFaceAnchors().flat_anchors(sizes[:3])
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_anchors_on_device_are_made_once():
    on = anchor.OnDevice(lambda sizes: (
        anchor.RetinaAnchors().flat_anchors(sizes),))
    first, = on(SIZES[0], torch.device("cpu"))
    again, = on(np.asarray(SIZES[0]), "cpu")
    assert again is first and len(on.cache) == 1
    assert np.array_equal(first.numpy(),
                          anchor.RetinaAnchors().flat_anchors(SIZES[0]))


# ---- RetinaFPN and the heads ------------------------------------------------

def _levels(channels, hw, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, h, h, c).astype(np.float32)
            for c, h in zip(channels, hw)]


def _jax_module_case(module, inputs, seed):
    """(params, outputs, gradients of sum(outputs * weights), weights)."""
    with jax_f32():
        shapes = jax.eval_shape(lambda: module.init(
            jax.random.PRNGKey(0), *inputs))
        params = random_params(shapes["params"], seed)
        out = jax.tree.leaves(module.apply({"params": params}, *inputs))
        rng = np.random.RandomState(seed + 1)
        weights = [rng.randn(*o.shape).astype(np.float32) for o in out]

        def loss(p):
            outs = jax.tree.leaves(module.apply({"params": p}, *inputs))
            return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

        grads = jax.jit(jax.grad(loss))(params)
    return (params, [np.asarray(o) for o in out],
            jax.tree.map(np.asarray, grads), weights)


def _check_module(port, root, jax_module, jax_inputs, port_call, seed):
    params, want, want_grads, weights = _jax_module_case(
        jax_module, jax_inputs, seed)
    load_jax_params(port, params, root=root)
    outs = port_call(port)
    outs = [o for o in (outs if isinstance(outs, (list, tuple)) else [outs])]
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        assert o.shape == w.shape
        np.testing.assert_allclose(o.detach().numpy(), w, atol=2e-5,
                                   rtol=1e-5)
    sum((o * _t(w)).sum() for o, w in zip(outs, weights)).backward()
    grads = export_jax_params(port, {n: p.grad for n, p in
                                     port.named_parameters()}, root=root)
    _assert_tree_close(grads, want_grads, 1e-5)


@pytest.mark.parametrize("use_p5", [False, True])
def test_retina_fpn_matches_jax(use_p5):
    channels = (16, 24, 40)
    c3, c4, c5 = _levels(channels, (12, 6, 3), 0)
    _check_module(
        fpn.RetinaFPN(channels, 32, use_p5, dtype=torch.float32), "fpn",
        jax_fpn.RetinaFPN(planes=32, use_p5=use_p5),
        [[jnp.asarray(c) for c in (c3, c4, c5)]],
        lambda m: m([_t(c) for c in (c3, c4, c5)]), 1)


@pytest.mark.parametrize("kind", ["cls", "reg", "fcos", "fcos_nogn"])
def test_heads_match_jax(kind):
    """One 64-wide level through each head: probabilities in f32, the
    GroupNorm towers, the prior bias's init."""
    x, = _levels((64,), (5,), 2)
    f32 = torch.float32
    if kind == "cls":
        port, root = head.RetinaClsHead(64, 3, 7, dtype=f32), "cls_head"
        jm = jax_head.RetinaClsHead(3, 7)
    elif kind == "reg":
        port, root = head.RetinaRegHead(64, 3, dtype=f32), "reg_head"
        jm = jax_head.RetinaRegHead(3)
    else:
        gn = kind == "fcos"
        port = head.FCOSClsRegCntHead(64, 7, use_gn=gn, cnt_on_reg=gn,
                                      dtype=f32)
        root, jm = "clsregcnt_head", jax_head.FCOSClsRegCntHead(
            7, use_gn=gn, cnt_on_reg=gn)
    _check_module(port, root, jm, [jnp.asarray(x)],
                  lambda m: m(_t(x)), 3)
    from simpleaicv_tpu_torch.models.common import init_params
    init_params(port, torch.Generator().manual_seed(0))
    if kind != "reg":
        assert torch.all(port.cls_out.bias == head.PRIOR_BIAS)
        assert head.PRIOR_BIAS == pytest.approx(jax_head.PRIOR_BIAS)
    tower = port.reg_head if kind == "reg" else port.cls_head
    assert abs(tower[0].weight.std().item() - 0.01) < 0.002


# ---- losses -----------------------------------------------------------------

def _annotations():
    """[3, 5, 5]: image 0 two boxes of equal area (20x40 and 40x20 on one
    centre) and a third; image 1 two identical boxes of different
    classes (every anchor's IoU ties) and one more; image 2 no box."""
    ann = np.full((3, 5, 5), -1.0, np.float32)
    ann[0, 0] = [40, 30, 60, 70, 2]
    ann[0, 1] = [30, 40, 70, 60, 4]
    ann[0, 2] = [4, 70, 100, 126, 1]
    ann[1, 0] = [10, 12, 58, 50, 3]
    ann[1, 1] = [10, 12, 58, 50, 0]
    ann[1, 2] = [60, 60, 120, 124, 5]
    return ann


def _predictions(kind, batch, classes, seed=0):
    """Per-level predictions at a 128^2 canvas: probabilities from a
    sigmoid, regressions from a normal."""
    rng = np.random.RandomState(seed)
    levels = 3 if kind == "face" else 5
    sizes = [IMG // s for s in STRIDES[:levels]]
    anchors = {"retina": (9,), "face": (3,), "fcos": ()}[kind]
    sig = lambda a: (1 / (1 + np.exp(-a))).astype(np.float32)  # noqa: E731
    cls = [sig(rng.randn(batch, h, h, *anchors, classes)) for h in sizes]
    reg = [(0.5 * rng.randn(batch, h, h, *anchors, 4)).astype(np.float32)
           for h in sizes]
    if kind != "fcos":
        return [cls, reg]
    return [cls, reg, [sig(rng.randn(batch, h, h, 1)) for h in sizes]]


LOSS_CASES = {
    "retina_smoothl1": ("retina", lambda m: m.RetinaLoss(), 6),
    "retina_giou": ("retina", lambda m: m.RetinaLoss(box_loss_type="GIoU"),
                    6),
    "fcos": ("fcos", lambda m: m.FCOSLoss(), 6),
    "fcos_ciou": ("fcos", lambda m: m.FCOSLoss(box_loss_iou_type="CIoU",
                                               use_center_sample=False), 6),
    "face": ("face", lambda m: m.RetinaFaceLoss(), 1),
}


class _JaxLosses:
    RetinaLoss = JaxRetinaLoss
    FCOSLoss = JaxFCOSLoss
    RetinaFaceLoss = jax_face.RetinaFaceLoss


class _PortLosses:
    RetinaLoss = RetinaLoss
    FCOSLoss = FCOSLoss
    RetinaFaceLoss = face_detection.RetinaFaceLoss


def _face_annotations():
    """The boxes with class 0 (one class), the tie and the empty image
    kept."""
    ann = _annotations()
    ann[..., 4] = np.where(ann[..., 4] >= 0, 0.0, -1.0)
    return ann


def _loss_case(case, annotations):
    kind, make, classes = LOSS_CASES[case]
    preds = _predictions(kind, annotations.shape[0], classes)
    jloss, ploss = make(_JaxLosses), make(_PortLosses)

    def terms(p, a):
        out = jloss(p, a)
        return sum(out.values()), out

    with jax_f32():
        want_grads, want = jax.jit(jax.grad(terms, has_aux=True))(
            jax.tree.map(jnp.asarray, preds), jnp.asarray(annotations))
    want = {k: float(v) for k, v in want.items()}
    want_grads = jax.tree.map(np.asarray, want_grads)
    tpreds = [[_t(p).requires_grad_() for p in group] for group in preds]
    got = ploss(tpreds, _t(annotations))
    sum(got.values()).backward()
    got_grads = [[p.grad.numpy() for p in group] for group in tpreds]
    return want, want_grads, {k: v.item() for k, v in got.items()}, \
        got_grads


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_values_and_gradients_match_jax(case):
    """Each term within 1e-5 relative, every prediction's gradient within
    1e-5 of the largest; the batch holds the equal-area and equal-IoU ties
    and an image without boxes."""
    ann = _face_annotations() if case == "face" else _annotations()
    want, want_grads, got, got_grads = _loss_case(case, ann)
    assert set(got) == set(want)
    for k, w in want.items():
        assert w > 0 and got[k] == pytest.approx(w, rel=1e-5), k
    for g_group, w_group in zip(got_grads, want_grads):
        for g, w in zip(g_group, w_group):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("case", ["retina_smoothl1", "fcos", "face"])
def test_a_batch_without_positives_gives_zero_and_finite_gradients(case):
    """Images without boxes only (and for RetinaNet one whose box is too
    small for any anchor to reach 0.5): every term is 0, as in the JAX
    package, and every gradient finite."""
    ann = np.full((2, 3, 5), -1.0, np.float32)
    ann[1, 0] = [60, 60, 62, 62, 0]   # too small to be positive
    want, _, got, got_grads = _loss_case(case, ann)
    assert want == {k: 0.0 for k in want}
    assert got == want
    for group in got_grads:
        for g in group:
            assert np.isfinite(g).all()


def _flat_anchors(kind, sizes):
    if kind == "face":
        return face_detection.RetinaFaceAnchors().flat_anchors(sizes)
    return anchor.RetinaAnchors().flat_anchors(sizes)


@pytest.mark.parametrize("kind", ["retina", "face"])
def test_anchor_assignment_matches_jax(kind):
    """Classes and boxes of every anchor equal the JAX package's; an
    anchor whose IoU ties between the two identical boxes takes the first
    one's class; the image without boxes is all ignored."""
    levels = 3 if kind == "face" else 5
    sizes = [[IMG // s, IMG // s] for s in STRIDES[:levels]]
    anchors = _flat_anchors(kind, sizes)
    ann = _face_annotations() if kind == "face" else _annotations()
    jl = jax_face.RetinaFaceLoss() if kind == "face" else JaxRetinaLoss()
    pl = (face_detection.RetinaFaceLoss() if kind == "face"
          else RetinaLoss())
    want_boxes, want_cls = (np.asarray(t) for t in jl._assign(
        jnp.asarray(anchors), jnp.asarray(ann)))
    got_boxes, got_cls = pl.assign(_t(anchors), _t(ann))
    assert np.array_equal(got_cls.numpy(), want_cls)
    assert np.array_equal(got_boxes.numpy(), want_boxes)
    assert (want_cls[2] == -1).all()
    pos = got_cls[1] > 0
    assert pos.any()
    # image 1's boxes 0 and 1 are one box: ties go to box 0 (class 3)
    tied = (got_boxes[1] == _t(ann[1, 0, :4])).all(-1) & pos
    assert tied.any()
    want_tie = 1.0 if kind == "face" else 4.0
    assert torch.all(got_cls[1][tied] == want_tie)
    thresholds = (0.35, 0.35) if kind == "face" else (0.4, 0.5)
    assert pl.thresholds == thresholds


def test_fcos_assignment_matches_jax_and_the_golden():
    """ltrb, classes and centerness of every point equal the JAX package's
    (centerness within 1e-6) and the golden test's numpy statement of the
    reference; equal-area boxes go to the first."""
    sizes = [[IMG // s, IMG // s] for s in STRIDES]
    jl, pl = JaxFCOSLoss(), FCOSLoss()
    points, strides, mi = pl._points(sizes)
    ann = _annotations()
    want = [np.asarray(t) for t in jl._assign(
        jnp.asarray(points), jnp.asarray(strides), jnp.asarray(mi),
        jnp.asarray(ann))]
    got = [t.numpy() for t in pl.assign(_t(points), _t(strides), _t(mi),
                                        _t(ann))]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    for i in range(ann.shape[0]):
        golden = ref_assign(points, strides, mi, ann[i])
        np.testing.assert_allclose(got[0][i], golden[:, :4], atol=1e-5)
        assert np.array_equal(got[1][i], golden[:, 4])
        np.testing.assert_allclose(got[2][i], golden[:, 5], atol=1e-6)
    # the 20x40 and 40x20 boxes of image 0 share their centre and area:
    # the stride-8 point (52, 52), positive for both, takes box 0 (class
    # 2 -> 3), not box 1 (class 4 -> 5)
    assert got[1][0][6 * 16 + 6] == 3
    assert (got[1][2] == 0).all()


def test_fcos_loss_matches_the_golden():
    """``tests/test_fcos_loss_golden.py``'s inputs and tolerance."""
    rng = np.random.RandomState(0)
    mi5 = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 100000000))
    sizes = [[IMG // s, IMG // s] for s in STRIDES]
    pos, stride_per_pt = anchor.FCOSPositions(
        STRIDES).flat_positions_strides(sizes)
    mi = np.concatenate([
        np.tile(np.asarray(mi5[i], np.float32)[None],
                (int(fs[0]) * int(fs[1]), 1)) for i, fs in enumerate(sizes)])
    b, nc = 2, 6
    cls_levels, reg_levels, cnt_levels = [], [], []
    for w, h in sizes:
        cls_levels.append(
            1 / (1 + np.exp(-rng.randn(b, h, w, nc))).astype(np.float32))
        reg_levels.append(rng.randn(b, h, w, 4).astype(np.float32))
        cnt_levels.append(
            1 / (1 + np.exp(-rng.randn(b, h, w, 1))).astype(np.float32))
    annots = np.full((b, 5, 5), -1.0, np.float32)
    annots[0, 0] = [8, 8, 70, 70, 2]
    annots[0, 1] = [20, 30, 110, 126, 4]
    annots[1, 0] = [4, 4, 40, 48, 1]

    ours = FCOSLoss()(([_t(c) for c in cls_levels],
                       [_t(r) for r in reg_levels],
                       [_t(c) for c in cnt_levels]), _t(annots))
    tgts = np.stack([ref_assign(pos, stride_per_pt, mi, annots[i])
                     for i in range(b)])
    tgts_full = np.concatenate([tgts, np.tile(pos[None], (b, 1, 1))], 2)
    flat = [np.concatenate([c.reshape(b, -1, c.shape[-1]) for c in lv], 1)
            for lv in (cls_levels, reg_levels, cnt_levels)]
    ref = ref_losses(*flat, tgts_full, pos)
    for key, r in zip(("cls_loss", "reg_loss", "center_ness_loss"), ref):
        assert abs(ours[key].item() - r) < 2e-3 * max(r, 1), key


def test_retina_loss_matches_the_golden():
    """``tests/test_retina_loss_golden.py``'s inputs and tolerance."""
    rng = np.random.RandomState(0)
    sizes = [[IMG // s, IMG // s] for s in STRIDES]
    anchors = anchor.RetinaAnchors().flat_anchors(sizes)
    b, nc = 2, 6
    cls_levels, reg_levels = [], []
    for w, h in sizes:
        cls_levels.append(
            1 / (1 + np.exp(-rng.randn(b, h, w, 9, nc))).astype(np.float32))
        reg_levels.append(rng.randn(b, h, w, 9, 4).astype(np.float32))
    annots = np.full((b, 6, 5), -1.0, np.float32)
    annots[0, 0] = [8, 8, 60, 60, 2]
    annots[0, 1] = [30, 40, 100, 120, 4]
    annots[1, 0] = [12, 20, 90, 70, 1]
    ours = RetinaLoss(box_loss_type="SmoothL1")(
        ([_t(c) for c in cls_levels], [_t(r) for r in reg_levels]),
        _t(annots))
    ref_cls, ref_reg = ref_retina_loss(
        np.concatenate([c.reshape(b, -1, nc) for c in cls_levels], 1),
        np.concatenate([r.reshape(b, -1, 4) for r in reg_levels], 1),
        anchors, annots)
    assert abs(ours["cls_loss"].item() - ref_cls) < 2e-3 * max(ref_cls, 1)
    assert abs(ours["reg_loss"].item() - ref_reg) < 2e-3 * max(ref_reg, 1)


# ---- decoders ---------------------------------------------------------------

DECODERS = {
    "retina": (lambda m, **kw: m.RetinaDecoder(**kw), 6),
    "fcos": (lambda m, **kw: m.FCOSDecoder(**kw), 6),
    "face": (lambda m, **kw: m.RetinaFaceDecoder(**kw), 1),
}


def _decoder_modules(kind):
    if kind == "face":
        return jax_face, face_detection
    return jax_decode, decode


def _decoder_inputs(kind, ties):
    """Predictions on a 128^2 canvas, 2 images; with ``ties`` the
    probabilities are rounded to tenths, so that many scores are equal."""
    _, classes = DECODERS[kind]
    preds = _predictions(kind, 2, classes, seed=4)
    if ties:
        preds[0] = [np.round(p, 1) for p in preds[0]]
        if kind == "fcos":
            preds[2] = [np.ones_like(p) for p in preds[2]]
    return preds


def _decode_both(kind, preds, **kwargs):
    make, _ = DECODERS[kind]
    jm, pm = _decoder_modules(kind)
    want = make(jm, **kwargs)(jax.tree.map(jnp.asarray, preds))
    got = make(pm, **kwargs)(jax.tree.map(_t, preds))
    return [np.asarray(w) for w in want], got


def _assert_decoded_equal(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[2], want[2])


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_decoder_matches_jax(kind, ties):
    """Scores within 1e-6 relative, classes and boxes exactly; with tied
    scores the lower index goes first on both sides. A threshold that few
    candidates pass leaves invalid slots: -1 / -1 / 0."""
    preds = _decoder_inputs(kind, ties)
    got, want = _decode_both(kind, preds, max_object_num=50,
                             min_score_threshold=0.05, topn=200)
    _assert_decoded_equal(got, want)
    got, want = _decode_both(kind, preds, max_object_num=50,
                             min_score_threshold=0.99, topn=200)
    _assert_decoded_equal(got, want)
    invalid = want[0] == -1
    assert invalid.any() and (want[1][invalid] == -1).all()
    assert (want[2][invalid] == 0).all()


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_decoder_pads_fewer_candidates_than_max_object_num(kind):
    """``topn`` below ``max_object_num``: the JAX decoder raises; the
    port's returns what the JAX decoder gives at ``max_object_num`` =
    ``topn``, padded with invalid slots."""
    preds = _decoder_inputs(kind, False)
    make, _ = DECODERS[kind]
    jm, pm = _decoder_modules(kind)
    with pytest.raises(Exception):
        make(jm, max_object_num=40, topn=30)(jax.tree.map(jnp.asarray,
                                                          preds))
    got = make(pm, max_object_num=40, topn=30)(jax.tree.map(_t, preds))
    want = [np.asarray(w) for w in make(jm, max_object_num=30, topn=30)(
        jax.tree.map(jnp.asarray, preds))]
    _assert_decoded_equal([g[:, :30] for g in got], want)
    assert (got[0][:, 30:] == -1).all() and (got[1][:, 30:] == -1).all()
    assert (got[2][:, 30:] == 0).all()


def test_decoders_reject_an_unknown_nms_type():
    with pytest.raises(ValueError, match="unknown nms_type"):
        decode.FCOSDecoder(nms_type="soft_nms")
