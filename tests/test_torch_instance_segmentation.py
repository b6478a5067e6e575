"""The port's SOLOv2 and YOLACT (ResNet-18, 128^2, 4 classes) against the
JAX package's, in f32 on the CPU: the models on seeded JAX weights and
BatchNorm statistics carried across by ``core.weights``, both losses and
their gradients on the same predictions and batch, Matrix NMS and both
decoders on the same predictions, the transforms and collaters against the
JAX ones (which use OpenCV), ``evaluate_coco_segm`` and the RLE codec.

Tolerances, unless a test says otherwise: forward outputs and losses within
1e-5 relative (outputs of their largest value), gradients within 1e-4 in
relative L2, the decoders' labels and kept masks equal and their scores
within 1e-6 relative."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import DECODERS as JAX_DECODERS
from simpleaicv_tpu.core.registry import LOSSES as JAX_LOSSES
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.data import instance_segmentation as jax_data
from simpleaicv_tpu.data import rle as jax_rle
from simpleaicv_tpu.models.instance_segmentation import decode as jax_decode
from simpleaicv_tpu.tasks import instance_segmentation as jax_task
from simpleaicv_tpu_torch.core.registry import DECODERS, LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.data import instance_segmentation as port_data
from simpleaicv_tpu_torch.data import rle as port_rle
from simpleaicv_tpu_torch.models.instance_segmentation import decode
from simpleaicv_tpu_torch.tasks import instance_segmentation as port_task

from _torch_port import (flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

SIDE, CLASSES = 128, 4
# narrow heads (GroupNorm's 32 groups need multiples of 32)
SOLO_KW = dict(num_classes=CLASSES, fpn_planes=64, mask_feature_planes=32,
               mask_feature_num_classes=64, bbox_inter_planes=64,
               instance_planes=64)
YOLACT_KW = dict(num_classes=CLASSES + 1, fpn_planes=64)
MODEL_CASES = {"resnet18_solov2": SOLO_KW, "resnet18_yolact": YOLACT_KW}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """PyTorch's own convolution backward (``tests/test_torch_trainer.py``:
    oneDNN's f32 one parts from an f64 reference by several percent)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _collated(collater_cls, n=2, hw=160, seed=0):
    """n fake samples through the fake_synthetic recipe's resize,
    normalisation and the port's collater."""
    ds = port_data.FakeInstanceSegmentationDataset(
        n, hw, CLASSES, transform=lambda s: port_data.InstanceNormalize()(
            port_data.InstanceSegmentationResize(SIDE)(s)))
    return collater_cls(SIDE)([ds[seed + i] for i in range(n)])


# ---- the models ------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def case(request):
    """(name, variables, image, JAX eval outputs as a flat list)."""
    name = request.param
    rng = np.random.RandomState(0)
    image = (rng.rand(2, SIDE, SIDE, 3) + rng.randn(2, 1, 1, 3)).astype(
        np.float32)
    with jax_f32():
        model = JAX_MODELS.create(name, **MODEL_CASES[name])
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), jnp.asarray(image), False))
        variables = {"params": random_params(shapes["params"], 1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], 2)}
        out = jax.jit(lambda v, x: model.apply(v, x, False))(variables,
                                                              image)
    return name, variables, image, [np.asarray(o)
                                    for o in jax.tree.leaves(out)]


def _port(name, variables):
    model = MODELS.create(name, dtype=torch.float32, **MODEL_CASES[name])
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"]).eval()


def _flat(out):
    """The model's outputs in ``jax.tree.leaves`` order."""
    leaves = []
    for o in out:
        leaves.extend(o if isinstance(o, (list, tuple)) else [o])
    return leaves


def test_forward_on_jax_weights(case):
    """Every eval-mode output within 1e-5 of its largest value."""
    name, variables, image, want = case
    with torch.no_grad():
        got = _flat(_port(name, variables)(torch.from_numpy(image)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (w.shape, err)


def test_weights_both_ways(case):
    """The tree comes back leaf for leaf; a shared tower (SOLOv2's kernel
    and category convolutions, YOLACT's head) is one set of leaves."""
    name, variables = case[0], case[1]
    model = _port(name, variables)
    for tree, back in ((variables["params"], export_jax_params(model)),
                       (variables["batch_stats"],
                        export_jax_batch_stats(model))):
        want, got = flatten_tree(tree), flatten_tree(back)
        assert set(got) == set(want)
        for path, w in want.items():
            assert np.array_equal(got[path], w), path
    extra = dict(variables["params"], extra={"kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="not consumed"):
        load_jax_params(MODELS.create(name, **MODEL_CASES[name]), extra,
                        batch_stats=variables["batch_stats"])


def test_variants_without_backbones_name_what_is_missing():
    """The VAN and ConvFormer variants, which waited for their backbones,
    build on them (their trees: ``tests/test_torch_backbone_variants.py``)."""
    for name, bb in (("vanb2_solov2", "VAN"),
                     ("convformerm36_yolact", "MetaFormer")):
        assert name in JAX_MODELS
        with torch.device("meta"):
            model = MODELS.create(name, num_classes=CLASSES)
        assert type(model.backbone).__name__ == bb


# ---- the losses ------------------------------------------------------------

def _jax_loss_and_grads(loss, preds, annots, masks):
    """(the loss terms, the gradients of their sum with respect to every
    prediction) of the JAX criterion, jitted."""
    def total(p):
        terms = loss(p, annots, masks)
        return sum(terms.values()), terms

    (_, terms), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, preds))
    return ({k: float(v) for k, v in terms.items()},
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port_loss_and_grads(loss, preds, annots, masks):
    leaves, tree = jax.tree.flatten(preds)
    tensors = [torch.tensor(np.asarray(p), requires_grad=True)
               for p in leaves]
    terms = loss(jax.tree.unflatten(tree, tensors), torch.from_numpy(annots),
                 torch.from_numpy(masks))
    sum(terms.values()).backward()
    return ({k: float(v) for k, v in terms.items()},
            [t.grad.numpy() for t in tensors])


def _assert_loss_parity(got, want, rel=None):
    """Each term within 1e-5 relative (or ``rel[term]``), the gradients
    within 1e-4 in relative L2."""
    (got_terms, got_grads), (want_terms, want_grads) = got, want
    assert set(got_terms) == set(want_terms)
    for key, w in want_terms.items():
        assert w > 0, key
        assert got_terms[key] == pytest.approx(
            w, rel=(rel or {}).get(key, 1e-5)), key
    for g, w in zip(got_grads, want_grads):
        assert g.shape == w.shape
        assert _rel_l2(g, w) <= 1e-4


def _solo_preds(rng, b, mr):
    """SOLOv2's predictions at the default grids: mask features, kernels
    and category logits drawn from ``rng``."""
    kernels = [rng.randn(b, g, g, 16).astype(np.float32) * 0.3
               for g in (40, 36, 24, 16, 12)]
    cates = [rng.randn(b, g, g, CLASSES).astype(np.float32) * 2 - 2
             for g in (40, 36, 24, 16, 12)]
    return (rng.randn(b, mr, mr, 16).astype(np.float32), kernels, cates)


def test_solov2_loss_and_gradients_match_jax():
    """On the collater's batch (pixel boxes, masks at 32^2), with a fourth
    image of two gts over the same cells (the last one wins)."""
    batch = _collated(port_data.SOLOV2InstanceSegmentationCollater, 3)
    annots, masks = batch["annots"], batch["gt_masks"]
    annots = np.concatenate([annots, annots[:1]]).copy()
    masks = np.concatenate([masks, masks[:1]]).copy()
    annots[3, 1] = annots[3, 0]
    annots[3, 1, 4] = (annots[3, 0, 4] + 1) % CLASSES
    masks[3, 1] = masks[3, 0]
    preds = _solo_preds(np.random.RandomState(3), 4, SIDE // 4)
    with jax_f32():
        want = _jax_loss_and_grads(JAX_LOSSES.create("SOLOV2Loss"), preds,
                                   annots, masks)
    _assert_loss_parity(_port_loss_and_grads(LOSSES.create("SOLOV2Loss"),
                                             preds, annots, masks), want)


def _yolact_preds(rng, b, side, nc):
    levels = [side // s for s in (8, 16, 32, 64, 128)]
    cls = [rng.randn(b, h, h, 3, nc).astype(np.float32) for h in levels]
    box = [rng.randn(b, h, h, 3, 4).astype(np.float32) * 0.5 for h in levels]
    coef = [np.tanh(rng.randn(b, h, h, 3, 8)).astype(np.float32)
            for h in levels]
    proto = np.maximum(rng.randn(b, side // 4, side // 4, 8), 0).astype(
        np.float32)
    seg = rng.randn(b, side // 8, side // 8, nc - 1).astype(np.float32)
    return cls, box, coef, proto, seg


def _dense_annots():
    """One image whose 100 ground truths sit on 100 of P3's square anchors
    (each also overlaps its cell's 1:2 anchor at IoU 0.55): about 300
    positives, so the mask loss takes its first 100 in anchor order."""
    scale = 24 * SIDE / 544.0
    annots = np.full((1, 100, 5), -1.0, np.float32)
    masks = np.zeros((1, 100, SIDE // 4, SIDE // 4), np.uint8)
    for j in range(100):
        cy, cx = divmod(j * 2 + 17, 16)
        x, y = (cx * 8 + 4) / SIDE, (cy * 8 + 4) / SIDE
        half = scale / 2 / SIDE
        annots[0, j] = [x - half, y - half, x + half, y + half, j % CLASSES]
        q = SIDE // 4
        masks[0, j, int((y - half) * q):int((y + half) * q) + 1,
              int((x - half) * q):int((x + half) * q) + 1] = 1
    return annots, masks


def test_yolact_loss_and_gradients_match_jax():
    """The collater's batch (relative boxes, masks at 32^2) and an image of
    more than 100 positives (the mask loss's cap)."""
    batch = _collated(port_data.YOLACTInstanceSegmentationCollater, 2)
    dense_annots, dense_masks = _dense_annots()
    annots = np.concatenate([batch["annots"], dense_annots])
    masks = np.concatenate([batch["gt_masks"], dense_masks])
    preds = _yolact_preds(np.random.RandomState(4), 3, SIDE, CLASSES + 1)
    port_loss = LOSSES.create("YOLACTLoss", resize=SIDE)
    cls_labels = port_loss._assign(
        torch.from_numpy(port_loss.anchors.flat_anchors(
            [(SIDE // s, SIDE // s) for s in (8, 16, 32, 64, 128)])),
        torch.from_numpy(annots))[0]
    assert int((cls_labels[2] > 0).sum()) > 100
    with jax_f32():
        want = _jax_loss_and_grads(
            JAX_LOSSES.create("YOLACTLoss", resize=SIDE), preds, annots,
            masks)
    # the mask loss sums 3 x 100 x 32^2 f32 BCE terms: XLA's sum parts from
    # an f64 run of the port by 1.2e-5 of it, the port's f32 sum by 9e-8
    _assert_loss_parity(_port_loss_and_grads(port_loss, preds, annots,
                                             masks), want,
                        rel={"mask_loss": 3e-5})


def test_yolact_assignment_with_shared_best_anchors_matches_jax():
    """Two ground truths with one box (so one best anchor: the last in
    slot order wins, as XLA's scatter gives it here) and one whose best
    anchor is anchor 0, where every empty slot's argmax also lands: the
    class labels, matched boxes and matched indices equal JAX's, the box
    targets (a log and a division) within 1e-6 relative."""
    port_loss = LOSSES.create("YOLACTLoss", resize=SIDE)
    anchors = port_loss.anchors.flat_anchors(
        [(SIDE // s, SIDE // s) for s in (8, 16, 32, 64, 128)])
    ann = np.full((2, 6, 5), -1.0, np.float32)
    ann[0, 0] = [0.3, 0.3, 0.5, 0.5, 1]
    ann[0, 1] = [0.3, 0.3, 0.5, 0.5, 2]
    ann[0, 2] = [0.0, 0.0, 0.04, 0.04, 3]
    ann[1, 0] = [0.1, 0.6, 0.7, 0.9, 0]
    jax_loss = JAX_LOSSES.create("YOLACTLoss", resize=SIDE)
    want = jax.vmap(lambda a: jax_loss._assign(jnp.asarray(anchors), a))(
        jnp.asarray(ann))
    got = port_loss._assign(torch.from_numpy(anchors), torch.from_numpy(ann))
    assert int((got[0][0] > 0).sum()) > 1
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 1:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert np.array_equal(g.numpy(), np.asarray(w)), i


def test_stable_topk_orders_ties_by_index():
    x = torch.tensor([[0.0, 1.0, 1.0, 0.5, 1.0, 0.0]])
    values, indices = decode.topk_stable(x, 5)
    assert indices.tolist() == [[1, 2, 4, 3, 0]]
    assert values.tolist() == [[1.0, 1.0, 1.0, 0.5, 0.0]]


# ---- the decoders ----------------------------------------------------------

def _distinct(rng, shape, scale):
    """Normal draws with no two values of a row within 1e-4 of each other
    (clear of top-k ties)."""
    x = rng.randn(*shape).astype(np.float32) * scale
    flat = x.reshape(-1)
    flat[:] = flat[np.argsort(flat)] + np.arange(flat.size) * 1e-4
    rng.shuffle(flat)
    return x


def test_matrix_nms_matches_jax():
    rng = np.random.RandomState(5)
    masks = rng.rand(12, 16, 16) > 0.4
    masks[3] = masks[1]
    labels = rng.randint(0, 3, 12)
    scores = np.sort(rng.rand(12))[::-1].astype(np.float32).copy()
    want = np.asarray(jax_decode.matrix_nms(jnp.asarray(masks),
                                            jnp.asarray(labels),
                                            jnp.asarray(scores)))
    got = decode.matrix_nms(torch.from_numpy(masks),
                            torch.from_numpy(labels),
                            torch.from_numpy(scores)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got < scores - 1e-3).any()


def _assert_decoded_equal(got, want):
    (gm, gl, gs), (wm, wl, ws) = got, want
    assert (ws > 0).sum() > 0
    assert np.array_equal(gl, wl)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    assert gm.dtype == np.bool_ and np.array_equal(gm, wm)


def test_solov2_decoder_matches_jax():
    rng = np.random.RandomState(6)
    mr = SIDE // 4
    grids = (40, 36, 24, 16, 12)
    mask_feat = _distinct(rng, (2, mr, mr, 16), 1.0)
    kernels = [_distinct(rng, (2, g, g, 16), 0.5) for g in grids]
    cates = [_distinct(rng, (2, g, g, CLASSES), 2.0) - 3.0 for g in grids]
    kw = dict(topn=100, max_object_num=20)
    with jax_f32():
        want = JAX_DECODERS.create("SOLOV2Decoder", **kw)(
            (mask_feat, kernels, cates))
    got = DECODERS.create("SOLOV2Decoder", **kw)(
        (torch.from_numpy(mask_feat), [torch.from_numpy(k) for k in kernels],
         [torch.from_numpy(c) for c in cates]))
    _assert_decoded_equal(got, want)


def test_yolact_decoder_matches_jax():
    rng = np.random.RandomState(7)
    levels = [SIDE // s for s in (8, 16, 32, 64, 128)]
    nc = CLASSES + 1
    cls = [_distinct(rng, (2, h, h, 3, nc), 2.0) for h in levels]
    box = [_distinct(rng, (2, h, h, 3, 4), 0.5) for h in levels]
    coef = [np.tanh(_distinct(rng, (2, h, h, 3, 8), 1.0)) for h in levels]
    proto = np.maximum(_distinct(rng, (2, SIDE // 4, SIDE // 4, 8), 1.0), 0)
    kw = dict(resize=SIDE, topn=50, max_object_num=20)
    with jax_f32():
        want = JAX_DECODERS.create("YOLACTDecoder", **kw)(
            (cls, box, coef, proto))
    got = DECODERS.create("YOLACTDecoder", **kw)(
        ([torch.from_numpy(c) for c in cls],
         [torch.from_numpy(b) for b in box],
         [torch.from_numpy(c) for c in coef], torch.from_numpy(proto)))
    _assert_decoded_equal(got, want)


# ---- data -------------------------------------------------------------------

@pytest.mark.parametrize("multi_scale", [False, True])
def test_transforms_match_jax(multi_scale):
    """The resize (OpenCV's INTER_LINEAR image and INTER_NEAREST masks in
    the JAX package), the flip and the normalisation, on the same draws:
    the masks equal; the image within 1e-2 of a level (4e-5 after the
    normalisation), the bound of ``tests/test_torch_classification_data.
    py`` (OpenCV computes the source coordinate in double, PyTorch in
    float; they part by up to 1.4e-3 of a level here)."""
    def pipeline(mod):
        return [mod.InstanceSegmentationResize(SIDE, multi_scale=multi_scale),
                mod.InstanceRandomHorizontalFlip(0.5), mod.InstanceNormalize()]

    for idx in range(4):
        outs = []
        for mod in (jax_data, port_data):
            random.seed(idx)
            np.random.seed(idx)
            sample = jax_data.FakeInstanceSegmentationDataset(
                8, 150 + 7 * idx, CLASSES)[idx]
            for t in pipeline(mod):
                sample = t(sample)
            outs.append(sample)
        want, got = outs
        assert got["image"].shape == want["image"].shape
        np.testing.assert_allclose(got["image"], want["image"],
                                   atol=1e-2 / 255)
        np.testing.assert_allclose(got["annots"], want["annots"], rtol=1e-6)
        assert got["scale"] == pytest.approx(want["scale"], rel=1e-6)
        for g, w in zip(got["masks"], want["masks"]):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("collater", [
    "SOLOV2InstanceSegmentationCollater",
    "YOLACTInstanceSegmentationCollater"])
def test_collaters_match_jax(collater):
    """The JAX collaters downscale each mask canvas with OpenCV's
    INTER_LINEAR; the port's with ``F.interpolate``: the masks equal."""
    ds = jax_data.FakeInstanceSegmentationDataset(
        4, 150, CLASSES, transform=jax_data.InstanceSegmentationResize(
            SIDE))
    samples = [ds[i] for i in range(4)]
    want = getattr(jax_data, collater)(SIDE)(samples)
    got = getattr(port_data, collater)(SIDE)(samples)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert np.array_equal(got[key], w), key


def test_rle_matches_jax():
    rng = np.random.RandomState(8)
    for h, w in ((1, 1), (7, 5), (33, 40)):
        mask = (rng.rand(h, w) > 0.5).astype(np.uint8)
        enc = port_rle.rle_encode(mask)
        assert enc == jax_rle.rle_encode(mask)
        assert np.array_equal(port_rle.rle_decode(enc), mask)
        assert np.array_equal(port_rle.rle_decode(
            {"size": [h, w], "counts": port_rle.mask_to_rle_counts(mask)}),
            mask)


# ---- the evaluation -------------------------------------------------------

class _JaxFixed:
    """A JAX 'model' whose apply returns fixed predictions."""

    def __init__(self, preds):
        self.preds = preds

    def apply(self, variables, images, train):
        return jax.tree.map(jnp.asarray, self.preds)


class _PortFixed(torch.nn.Module):

    def __init__(self, preds):
        super().__init__()
        self.preds = preds

    def forward(self, images):
        return jax.tree.map(torch.from_numpy, self.preds)


def test_evaluate_coco_segm_matches_jax():
    """The mask mAP of the same decoded predictions against the
    collater's masks, the decoded masks pooled to the gt grid: the
    statistics equal, and some detection matched."""
    batch = _collated(port_data.SOLOV2InstanceSegmentationCollater, 2)
    rng = np.random.RandomState(9)
    mr = SIDE // 4
    grids = (40, 36, 24, 16, 12)
    gt = batch["gt_masks"].astype(np.float32)
    # mask features whose channel j is the first image's gt mask j (and
    # noise), kernels picking one channel each: some masks match
    mask_feat = np.concatenate([
        np.concatenate([gt[0, :3].transpose(1, 2, 0) * 12 - 6,
                        rng.randn(mr, mr, 13)], -1)[None].repeat(2, 0)],
        0).astype(np.float32)
    kernels = [np.where(rng.rand(2, g, g, 16) < 1 / 16, 1.0, 0.0).astype(
        np.float32) for g in grids]
    cates = [_distinct(rng, (2, g, g, CLASSES), 2.0) - 2.0 for g in grids]
    preds = (mask_feat, kernels, cates)
    kw = dict(topn=100, max_object_num=20)
    with jax_f32():
        want = jax_task.evaluate_coco_segm(
            _JaxFixed(preds), {}, {},
            JAX_DECODERS.create("SOLOV2Decoder", **kw), [batch], CLASSES)
    got = port_task.evaluate_coco_segm(
        _PortFixed(preds), DECODERS.create("SOLOV2Decoder", **kw), [batch],
        CLASSES, lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    assert want["IoU=0.5,area=all,maxDets=100,mAP"] > 0
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key] == pytest.approx(float(w), rel=1e-6, abs=1e-9), key
