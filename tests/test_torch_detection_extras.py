"""The detection odds and ends of the port against the JAX package, in f32
on the CPU: DCNv2 (``ops/dcnv2.py``: values and the four gradients, and
the module through the weight bridge; on the CPU its sampling runs MSDA's
plain versions, on the card K7 and K7b), the mosaic augmentation (the same
choices from alike seeds, pixels within 1e-3 of cv2's resize), the anchor
k-means (equal), and the Objects365 CLI on a tiny COCO-layout tree with
both repository configs (``latest`` every epoch, no evaluation)."""

import os
import random
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.data.mosaic import MosaicResizeDetection as JaxMosaic
from simpleaicv_tpu.data.yolov3_anchor_cluster import kmeans_anchors as \
    jax_kmeans
from simpleaicv_tpu.ops.dcnv2 import DeformConv2d as JaxDeformConv2d
from simpleaicv_tpu.ops.dcnv2 import deform_conv2d as jax_deform_conv2d
from simpleaicv_tpu_torch.core.weights import load_jax_params
from simpleaicv_tpu_torch.data.mosaic import MosaicResizeDetection
from simpleaicv_tpu_torch.data.yolov3_anchor_cluster import (iou_wh,
                                                             kmeans_anchors)
from simpleaicv_tpu_torch.ops import dcnv2
from simpleaicv_tpu_torch.ops.dcnv2 import DeformConv2d, deform_conv2d
from simpleaicv_tpu_torch.tools import train_objects365_detection as o365

from _torch_port import one_torch_thread
from test_torch_readers_coco import write_coco

REPO = Path(__file__).resolve().parent.parent
O365 = REPO / "experiments/3.detection_training/objects365"


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _dcn_inputs(seed, b, h, w, c, o, k, stride):
    rng = np.random.RandomState(seed)
    ho, wo = -(-h // stride), -(-w // stride)
    # offsets of a few pixels carry taps across cells and off the image
    return (rng.randn(b, h, w, c).astype(np.float32),
            (rng.randn(b, ho, wo, 2 * k * k) * 2.5).astype(np.float32),
            rng.rand(b, ho, wo, k * k).astype(np.float32),
            (rng.randn(k, k, c, o) * 0.1).astype(np.float32))


@pytest.mark.parametrize("c,stride", [(64, 1), (64, 2), (24, 1)])
def test_deform_conv2d_values_and_gradients_match_jax(c, stride):
    """C 64 goes as two heads of 32 (the tiled kernels' layout on the card),
    C 24 as one head of 24."""
    x, off, mask, kernel = _dcn_inputs(0, 2, 9, 11, c, 16, 3, stride)
    g = np.random.RandomState(1).randn(
        2, off.shape[1], off.shape[2], 16).astype(np.float32)

    def loss(*args):
        return jnp.sum(jax_deform_conv2d(*args, stride=stride) * g)

    want = np.asarray(jax.jit(lambda *a: jax_deform_conv2d(
        *a, stride=stride))(x, off, mask, kernel))
    want_grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        x, off, mask, kernel)
    inputs = [torch.from_numpy(a).requires_grad_()
              for a in (x, off, mask, kernel)]
    got = deform_conv2d(*inputs, stride=stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(("x", "offsets", "mask", "kernel"), inputs,
                          want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_sample_layout_is_one_level_one_point_heads_of_32():
    x, off, mask, _ = _dcn_inputs(2, 2, 6, 7, 256, 8, 3, 1)
    value, shapes, loc, wts = dcnv2.sample_layout(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask), 3)
    assert tuple(value.shape) == (2, 42, 8, 32) and shapes == ((6, 7),)
    assert tuple(loc.shape) == (2, 6 * 7 * 9, 8, 1, 1, 2)
    assert tuple(wts.shape) == (2, 6 * 7 * 9, 8, 1, 1)
    # every head samples the same place with the same weight
    assert torch.equal(loc[:, :, :1].expand_as(loc), loc)
    assert torch.equal(wts[:, :, :1].expand_as(wts), wts)


def test_deform_conv_module_matches_jax_through_the_bridge():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    jax_model = JaxDeformConv2d(planes=16, stride=2)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), x)
    # move the zero-initialised offset convolution so the taps deform
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(
            np.float32), variables["params"])
    model = load_jax_params(DeformConv2d(32, 16, stride=2), params)
    want = np.asarray(jax.jit(jax_model.apply)({"params": params}, x))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


class _Boxes:
    """Four images of different sizes with boxes (x1, y1, x2, y2, class);
    image 2 has none."""

    def __init__(self):
        rng = np.random.RandomState(4)
        self.samples = []
        for i, (h, w) in enumerate([(50, 70), (64, 48), (40, 40), (80, 60)]):
            img = (rng.rand(h, w, 3) * 255).astype(np.float32)
            n = 0 if i == 2 else 3
            xy = rng.uniform(0, [w / 2, h / 2], (n, 2))
            wh = rng.uniform(6, [w / 2, h / 2], (n, 2))
            ann = np.concatenate([xy, xy + wh, rng.randint(0, 5, (n, 1))],
                                 1).astype(np.float32)
            self.samples.append({"image": img, "annots": ann,
                                 "scale": np.float32(1.0),
                                 "size": np.array([h, w], np.float32)})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        s = self.samples[idx]
        return {k: np.copy(v) for k, v in s.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mosaic_chooses_as_jax_and_resizes_within_1e_3(seed):
    data = _Boxes()
    jax_mosaic = JaxMosaic(data, resize=64, mosaic_prob=0.7)
    port = MosaicResizeDetection(data, resize=64, mosaic_prob=0.7,
                                 rng=random.Random(seed))
    random.seed(seed)
    mosaics = 0
    for idx in [0, 1, 2, 3, 1, 0, 3, 2]:
        want, got = jax_mosaic[idx], port[idx]
        assert want["image"].shape == got["image"].shape
        mosaics += want["image"].shape == (64, 64, 3)
        np.testing.assert_allclose(got["image"], want["image"], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(got["annots"], want["annots"],
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(got["size"], want["size"])
    assert mosaics > 0


def test_kmeans_anchors_equal_jax():
    rng = np.random.RandomState(5)
    wh = np.concatenate([rng.lognormal(3, 0.6, (300, 2)),
                         rng.lognormal(5, 0.4, (200, 2))])
    for k, seed in [(9, 0), (5, 3)]:
        want, want_iou = jax_kmeans(wh, k=k, seed=seed)
        got, got_iou = kmeans_anchors(wh, k=k, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert got_iou == want_iou
    assert iou_wh(np.array([[2.0, 3.0]]), np.array([[2.0, 3.0]]))[0, 0] == 1


def _o365_config(work, name, data_root):
    """The repository's Objects365 config, its data path set to
    ``data_root`` and its sizes shrunk to a 64^2 ResNet-18 detector."""
    src = (O365 / name / "train_config.py").read_text()
    for old, new in [("from path import Objects365_path  # noqa: E402",
                      f"Objects365_path = {str(data_root)!r}"),
                     ('network = "resnet50_', 'network = "resnet18_'),
                     ("input_image_size = 1024", "input_image_size = 64"),
                     ("batch_size = 64", "batch_size = 2"),
                     ("num_workers = 8", "num_workers = 1"),
                     ("epochs = 13", "epochs = 2"),
                     ("print_interval = 100", "print_interval = 1")]:
        assert old in src, old
        src = src.replace(old, new)
    (work / "train_config.py").write_text(src)


@pytest.mark.parametrize("name", ["res50_fcos_yoloresize1024",
                                  "res50_retinanet_yoloresize1024"])
def test_objects365_cli_saves_latest_every_epoch_without_evaluation(
        tmp_path, monkeypatch, name):
    root = tmp_path / "objects365_2020"
    write_coco(str(root), "train", n_images=4)
    write_coco(str(root), "val", n_images=2, seed=1)
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    work = tmp_path / "work"
    work.mkdir()
    _o365_config(work, name, root)
    o365.main(["--work-dir", str(work)])
    ckpt = work / "checkpoints"
    # both epochs saved their latest (the manager keeps two)
    assert sorted(os.listdir(ckpt / "latest")) == ["1.pt", "2.pt"]
    log = "".join(p.read_text() for p in (work / "log").glob("*"))
    assert "epoch 2 done" in log
    # the best epoch is chosen by the training loss: nothing was evaluated
    assert "mAP" not in log and "best -" in log
