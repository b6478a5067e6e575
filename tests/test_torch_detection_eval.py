"""The port's detection evaluation against the JAX package's, on the CPU:
greedy NMS at IoU and DIoU (keep masks and ``batched_nms`` exact), the
DINO-DETR and DETR decoders fed the same predictions (classes exact, boxes
within 1e-5 relative, scores within 1e-6 relative: a sigmoid or softmax
parts from XLA's by an ulp), the COCO evaluator (every statistic
exact), and ``evaluate_coco`` over a tiny DINO-DETR (resnet18_dinodetr at
128^2, ``TINY_DINO``) on weights carried across by ``load_jax_params``
(every statistic within 1e-4). Also the detection loss function, and two
faults of the runtime the CLIs met: the MACs counter on a model that
broadcasts a parameter, and a second run's log in the same process."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.data.datasets.coco import \
    FakeDetectionDataset as JaxFakeDataset
from simpleaicv_tpu.data import detection as jax_det
from simpleaicv_tpu.data.loader import DataLoader as JaxLoader
from simpleaicv_tpu.data.transforms import Compose as JaxCompose
from simpleaicv_tpu.evaluation.coco_eval import \
    CocoMAPEvaluator as JaxEvaluator
from simpleaicv_tpu.models.detection.detr_decode import \
    DETRDecoder as JaxDETRDecoder
from simpleaicv_tpu.models.detection.dinodetr_decode import \
    DINODETRDecoder as JaxDINODecoder
from simpleaicv_tpu.ops import nms as jax_nms
from simpleaicv_tpu.tasks import detection as jax_task
from simpleaicv_tpu_torch.core.logging_utils import get_logger
from simpleaicv_tpu_torch.core.profile import compute_macs_and_params
from simpleaicv_tpu_torch.core.registry import DECODERS, MODELS
from simpleaicv_tpu_torch.core.trainer import batch_to_device
from simpleaicv_tpu_torch.core.weights import load_jax_params
from simpleaicv_tpu_torch.data import detection as port_det
from simpleaicv_tpu_torch.data.datasets import FakeDetectionDataset
from simpleaicv_tpu_torch.data.loader import DataLoader
from simpleaicv_tpu_torch.data.transforms import Compose
from simpleaicv_tpu_torch.evaluation.coco_eval import CocoMAPEvaluator
from simpleaicv_tpu_torch.models.common import Linear
from simpleaicv_tpu_torch.ops import nms as port_nms
from simpleaicv_tpu_torch.tasks import detection as port_task

from _torch_port import (TINY_DINO, jax_f32, random_batch_stats,
                         random_params)


def _boxes(b, k, seed, spread=60.0):
    """[b, k, 4] xyxy boxes in clusters (so that many overlap) and [b, k]
    distinct scores."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 100, (b, 6, 2))[:, rng.randint(0, 6, k)]
    ctr = centres + rng.randn(b, k, 2) * spread / 10
    wh = rng.uniform(8, spread, (b, k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = np.stack([rng.permutation(k) for _ in range(b)]) / k + 0.001
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("nms_type", ["python_nms", "diou_python_nms"])
@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_nms_keep_mask_matches_jax(nms_type, threshold):
    boxes, scores = _boxes(3, 300, seed=0)
    keep = port_nms.nms_keep_mask(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), threshold,
                                  nms_type).numpy()
    for i in range(3):
        want = np.asarray(jax_nms.nms_keep_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), threshold,
            nms_type))
        got = port_nms.nms_keep_mask(torch.from_numpy(boxes[i]),
                                     torch.from_numpy(scores[i]), threshold,
                                     nms_type).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(keep[i], want)
        assert 0 < want.sum() < 300


@pytest.mark.parametrize("nms_type", ["python_nms", "diou_python_nms"])
@pytest.mark.parametrize("k,max_output", [(300, 100), (40, 64)])
def test_batched_nms_matches_jax(nms_type, k, max_output):
    boxes, scores = _boxes(2, k, seed=1)
    want = jax_nms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                               max_output=max_output, iou_threshold=0.5,
                               nms_type=nms_type)
    got = port_nms.batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               max_output=max_output, iou_threshold=0.5,
                               nms_type=nms_type)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _dino_preds(b, q, c, seed):
    rng = np.random.RandomState(seed)
    return {"pred_logits": (rng.randn(b, q, c) * 2 - 6).astype(np.float32),
            "pred_boxes": rng.uniform(0.05, 0.95, (b, q, 4)).astype(
                np.float32) * np.array([1, 1, 0.5, 0.5], np.float32)}


def _decoded_close(got, want):
    """Classes exact, the boxes (which name the chosen queries in their
    order) within 1e-5, the scores within 1e-6 relative: XLA's exp and
    torch's part by an ulp, so a sigmoid or softmax can too."""
    np.testing.assert_array_equal(got[0] == -1, want[0] == -1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=0)
    assert got[0].dtype == got[1].dtype == got[2].dtype == np.float32


SIZES = np.array([[128.0, 96.0], [80.0, 128.0]], np.float32)


@pytest.mark.parametrize("kwargs", [
    dict(topn=60, max_object_num=50),
    dict(topn=300, max_object_num=20, min_score_threshold=0.3),
    dict(topn=60, max_object_num=50, nms_type="diou_python_nms",
         nms_threshold=0.4),
    dict(topn=60, max_object_num=50, nms_type=""),
])
def test_dinodetr_decoder_matches_jax(kwargs):
    preds = _dino_preds(2, 100, 8, seed=2)
    want = JaxDINODecoder(num_classes=8, **kwargs)(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(SIZES))
    got = DECODERS.create("DINODETRDecoder", num_classes=8, **kwargs)(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        torch.from_numpy(SIZES))
    _decoded_close(got, want)
    assert (got[0] > -1).sum() > 0 and (got[0] == -1).sum() > 0


def test_dinodetr_decoder_pads_past_its_candidates():
    """Fewer queries than ``max_object_num`` (where the JAX decoder
    raises): the first slots are the JAX decoder's at that count, the rest
    invalid."""
    preds = _dino_preds(2, 12, 8, seed=3)
    want = JaxDINODecoder(num_classes=8, max_object_num=12)(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(SIZES))
    got = DECODERS.create("DINODETRDecoder", num_classes=8,
                          max_object_num=30)(
        {k: torch.from_numpy(v) for k, v in preds.items()}, SIZES)
    assert got[0].shape == (2, 30) and got[2].shape == (2, 30, 4)
    _decoded_close([a[:, :12] for a in got], want)
    assert (got[0][:, 12:] == -1).all() and (got[1][:, 12:] == -1).all()
    assert not got[2][:, 12:].any()


@pytest.mark.parametrize("q", [20, 150])
def test_detr_decoder_matches_jax(q):
    rng = np.random.RandomState(q)
    cls = (rng.randn(3, 2, q, 9) * 2).astype(np.float32)
    reg = rng.uniform(0.05, 0.6, (3, 2, q, 4)).astype(np.float32)
    want = JaxDETRDecoder(num_classes=8)(
        [jnp.asarray(cls), jnp.asarray(reg)], jnp.asarray(SIZES))
    got = DECODERS.create("DETRDecoder", num_classes=8)(
        [torch.from_numpy(cls), torch.from_numpy(reg)],
        torch.from_numpy(SIZES))
    _decoded_close(got, want)
    assert got[0].shape == (2, 100)


def test_coco_evaluator_matches_jax():
    """Eight images, 3 classes: detections near the ground truths (some
    matched at each threshold), some far, boxes of every area range."""
    rng = np.random.RandomState(4)
    ours, theirs = CocoMAPEvaluator(3), JaxEvaluator(3)
    for _ in range(8):
        n = rng.randint(1, 6)
        xy = rng.uniform(0, 300, (n, 2))
        wh = rng.choice([10.0, 50.0, 150.0], (n, 1)) * rng.uniform(
            0.8, 1.2, (n, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gt_cls = rng.randint(0, 3, n)
        d = rng.randint(0, 8)
        src = rng.randint(0, n, d)
        det = gt[src] + rng.randn(d, 4).astype(np.float32) * 6
        det_cls = np.where(rng.rand(d) < 0.8, gt_cls[src],
                           rng.randint(0, 3, d))
        scores = rng.uniform(0.05, 1.0, d).astype(np.float32)
        for ev in (ours, theirs):
            ev.add_image(det, scores, det_cls, gt, gt_cls)
    got, want = ours.compute(), theirs.compute()
    assert got == want
    assert 0 < got["IoU=0.5:0.95,area=all,maxDets=100,mAP"] < 1


# ------------------------- evaluate_coco, end to end -----------------------

IMG = 128


def _transform(mod, compose):
    return compose([mod.DetectionResize(resize=IMG, resize_type="yolo_style"),
                    mod.Normalize()])


@pytest.fixture(scope="module")
def coco_run():
    """The JAX ``evaluate_coco`` of a tiny DINO-DETR with seeded weights
    over 4 synthetic 100^2 images resized to 128^2, in f32."""
    dataset = JaxFakeDataset(num_samples=4, image_hw=100, num_classes=8,
                             transform=_transform(jax_det, JaxCompose))
    loader = JaxLoader(dataset, 2, jax_det.DETRDetectionCollater(
        IMG, max_annots_num=4), shuffle=False, drop_last=False,
        num_workers=1)
    decoder = JaxDINODecoder(num_classes=8, max_object_num=10)
    with jax_f32():
        model = JAX_MODELS.create("resnet18_dinodetr", **TINY_DINO)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0)},
            jnp.zeros((2, IMG, IMG, 3)), None, False))
        params = random_params(shapes["params"], seed=1)
        stats = random_batch_stats(shapes["batch_stats"], seed=2)
        result = jax_task.evaluate_coco(model, params,
                                        {"batch_stats": stats}, decoder,
                                        loader, 8)
    return params, stats, result


def test_evaluate_coco_matches_jax(coco_run):
    params, stats, want = coco_run
    model = load_jax_params(
        MODELS.create("resnet18_dinodetr", **TINY_DINO, dtype=torch.float32),
        params, batch_stats=stats)
    model.train()
    dataset = FakeDetectionDataset(num_samples=4, image_hw=100, num_classes=8,
                                   transform=_transform(port_det, Compose))
    loader = DataLoader(dataset, 2, port_det.DETRDetectionCollater(
        IMG, max_annots_num=4), shuffle=False, drop_last=False,
        num_workers=1)
    got = port_task.evaluate_coco(
        model, DECODERS.create("DINODETRDecoder", num_classes=8,
                               max_object_num=10), loader, 8,
        lambda batch: batch_to_device(batch, torch.device("cpu")))
    assert model.training  # the mode comes back
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-4), key
    assert got["key_metric"] == pytest.approx(
        100 * got["IoU=0.5:0.95,area=all,maxDets=100,mAP"])


def test_evaluate_coco_calls_a_decoder_by_its_kind():
    """A decoder without ``takes_sizes`` gets the outputs alone; a
    ``TypeError`` raised inside a decoder is not swallowed."""
    class Plain:
        def __call__(self, outs):
            b = outs.shape[0]
            return (np.full((b, 1), 0.9, np.float32), np.zeros((b, 1)),
                    np.array([[[0, 0, 10, 10]]] * b, np.float32))

    class Broken:
        takes_sizes = True

        def __call__(self, outs, sizes):
            raise TypeError("inside the decoder")

    batch = {"image": np.zeros((2, 4, 4, 3), np.float32),
             "scale": np.ones(2, np.float32),
             "size": np.full((2, 2), 4.0, np.float32),
             "annots": np.array([[[0, 0, 10, 10, 0]]] * 2, np.float32)}
    to_dev = lambda b: batch_to_device(b, torch.device("cpu"))  # noqa: E731
    stats = port_task.evaluate_coco(torch.nn.Identity(), Plain(), [batch],
                                    1, to_dev)
    assert stats["key_metric"] == pytest.approx(100.0)
    with pytest.raises(TypeError, match="inside the decoder"):
        port_task.evaluate_coco(torch.nn.Identity(), Broken(), [batch], 1,
                                to_dev)


def test_detection_loss_fn_sums_the_criterion_terms():
    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.tensor(2.0))

        def forward(self, x, train=False):
            return self.w * x.mean() * (2.0 if train else 1.0)

    def criterion(out, annots):
        return {"a": out, "b": annots.sum()}

    batch = {"image": torch.ones(2, 4, 4, 3), "annots": torch.ones(2, 3, 5)}
    loss, metrics = port_task.make_loss_fn(criterion)(Toy(), batch, None,
                                                      True)
    assert loss.item() == pytest.approx(4.0 + 30.0)
    assert metrics["a"].item() == pytest.approx(4.0)


def test_macs_of_a_model_that_broadcasts_a_parameter():
    """A view of a parameter taken under no_grad (DETR's broadcast query
    embedding) fed to a sub-module: the MACs counter's module tracker used
    to fail on it; the parameters require gradients again after."""
    class Queries(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.query = torch.nn.Parameter(torch.randn(5, 8))
            self.head = Linear(8, 3)

        def forward(self, x):
            q = self.query[None].expand(x.shape[0], -1, -1)
            return self.head(q + x.mean())

    model = Queries()
    model.head.reset_parameters(torch.Generator().manual_seed(0))
    macs, params = compute_macs_and_params(model, torch.zeros(2, 4, 4, 3))
    assert macs == 2 * 5 * 8 * 3 and params == 5 * 8 + 8 * 3 + 3
    assert all(p.requires_grad for p in model.parameters())


def test_a_second_run_logs_to_its_own_directory(tmp_path):
    """Two trainers in one process (a CLI's ``main`` called twice) each
    write ``<work_dir>/log/train.log``."""
    name = "test_torch_detection_eval_logger"
    for run in ("first", "second"):
        get_logger(name, str(tmp_path / run / "log")).info(f"{run} run")
    for handler in logging.getLogger(name).handlers:
        handler.flush()
    for run in ("first", "second"):
        text = (tmp_path / run / "log" / f"{name}.log").read_text()
        assert f"{run} run" in text and len(text.splitlines()) == 1
