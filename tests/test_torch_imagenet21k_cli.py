"""The port's ImageNet-21K CLIs and ``prepare_dataset``
(``simpleaicv_tpu_torch/tools/{train,test}_imagenet21k_classification.py``,
``tools/prepare_dataset.py``) on the CPU:

* the repository's ``imagenet21k/resnet50`` recipe, shrunk (ResNet-18 at
  32^2, a ten-class semantic tree written with ``torch.save``, JPEG
  folders written by cv2, batch 4), trains an epoch, resumes to a second
  and tests its best: the test CLI's pooled accuracy equals the best the
  training logged. The recipe's ``ClassificationCollater`` gives no
  ``semantic_label``; the CLIs take the labels from the tree's table;
* that table equal to the JAX reader's conversion and to the
  ``semantic_label`` of ``ImageNet21KSemanticCollater``, whose ``label``
  the CLIs read as they read any collater's, and the CLI's loss on
  given logits equal to the JAX ``SemanticSoftmaxLoss`` (1e-6 relative);
* without ``SIMPLEAICV_PLATFORM=cpu`` the CLIs ask for the card and raise
  here, before they write anything;
* ``pack-cifar`` writes the JAX package's pack byte for byte, and
  ``pack-imagefolder`` a pack of the folder's classes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.data.datasets import imagenet21k as jax_21k
from simpleaicv_tpu.data.datasets.cifar import CIFAR100Dataset as JaxCIFAR
from simpleaicv_tpu.data.packed import pack_dataset as jax_pack_dataset
from simpleaicv_tpu.losses.classification import \
    SemanticSoftmaxLoss as JaxSemanticSoftmaxLoss
from simpleaicv_tpu_torch.data import packed
from simpleaicv_tpu_torch.data.datasets import imagenet21k
from simpleaicv_tpu_torch.tools import prepare_dataset
from simpleaicv_tpu_torch.tools import test_imagenet21k_classification as tcli
from simpleaicv_tpu_torch.tools import \
    train_imagenet21k_classification as cli

from _torch_port import one_torch_thread
from test_torch_imagenet_data import _image_tree, _tree_file, _write_cifar

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "experiments/0.classification_training/imagenet21k/resnet50"


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _data(root):
    """``<root>/ImageNet21K``: the tree and train/val folders of JPEGs."""
    base = root / "ImageNet21K"
    base.mkdir(parents=True)
    n = _tree_file(base / "imagenet21k_miil_tree.pth")
    classes = [f"c{i:02d}" for i in range(n)]
    _image_tree(base / "train", classes, per_class=2, seed=1)
    _image_tree(base / "val", classes, per_class=1, seed=2)
    return n


def _recipe(work_dir, epochs, data_root):
    """The recipe shrunk, its data path (``tools/path.py``'s, which a
    process imports once) set to ``data_root``."""
    src = (RECIPE / "train_config.py").read_text()
    for old, new in [("from path import ImageNet21K_path  # noqa: E402",
                      f"ImageNet21K_path = {str(data_root)!r}"),
                     ('network = "resnet50"', 'network = "resnet18"'),
                     ("num_classes = 10450", "num_classes = 10"),
                     ("input_image_size = 224", "input_image_size = 32"),
                     ("Resize(resize=256)", "Resize(resize=36)"),
                     ("batch_size = 1024", "batch_size = 4"),
                     ("num_workers = 16", "num_workers = 1"),
                     ("epochs = 80", f"epochs = {epochs}"),
                     ("print_interval = 100", "print_interval = 2")]:
        assert old in src, old
        src = src.replace(old, new)
    (work_dir / "train_config.py").write_text(src)
    test = (RECIPE / "test_config.py").read_text()
    old = 'trained_model_path = ""'
    assert old in test
    (work_dir / "test_config.py").write_text(test.replace(
        old, 'trained_model_path = os.path.join(os.path.dirname('
        'os.path.abspath(__file__)), "checkpoints", "best")'))


def test_clis_train_resume_and_test_on_the_cpu(tmp_path, monkeypatch):
    _data(tmp_path / "data")
    root = tmp_path / "data/ImageNet21K"
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    work = tmp_path / "work"
    work.mkdir()
    _recipe(work, 1, root)
    cli.main(["--work-dir", str(work)])
    ckpt = work / "checkpoints"
    assert (ckpt / "best").is_file() and (ckpt / "latest/1.pt").is_file()
    _recipe(work, 2, root)
    cli.main(["--work-dir", str(work)])
    log = (work / "log/train.log").read_text()
    assert "resumed from epoch 1" in log
    assert "epoch 2 done" in log and "imgs/s" in log
    losses = [float(v) for v in re.findall(r"loss ([0-9.]+)", log)]
    assert losses and all(np.isfinite(losses))
    best = max(float(v) for v in re.findall(r"'acc1': ([0-9.]+)", log))
    metrics = tcli.main(["--work-dir", str(work)])
    assert len(metrics["per_level"]) == 3
    assert metrics["acc"] == pytest.approx(best, abs=1e-3)


def test_the_tree_table_and_loss_match_jax(tmp_path):
    n = _data(tmp_path)
    root = str(tmp_path / "ImageNet21K")
    mine = imagenet21k.ImageNet21KSemanticTreeLabelDataset(root)
    theirs = jax_21k.ImageNet21KSemanticTreeLabelDataset(root)
    tree = cli.SemanticTree(mine)
    labels = torch.tensor([9, 0, 5, 8, 3])
    want = theirs.convert_single_labels_to_semantic_labels(labels.numpy())
    np.testing.assert_array_equal(tree.labels({"label": labels}).numpy(),
                                  want)
    samples = [{"image": np.zeros((2, 2, 3), np.float32), "label": int(i)}
               for i in labels]
    batch = imagenet21k.ImageNet21KSemanticCollater(mine)(samples)
    np.testing.assert_array_equal(batch["semantic_label"], want)
    np.testing.assert_array_equal(
        tree.labels({"label": torch.from_numpy(batch["label"])}).numpy(),
        want)
    logits = torch.from_numpy(np.random.RandomState(0).randn(5, n).astype(
        np.float32))
    make_loss, make_eval = cli.make_adapters(tree, smoothing=0.1)

    def model(x, generator=None):
        return logits

    loss, _ = make_loss()(model, {"image": None, "label": labels}, None,
                          True)
    theirs._load_tree()
    jax_loss = JaxSemanticSoftmaxLoss(
        [float(f) for f in theirs.normalization_factor_list], smoothing=0.1)(
        [jnp.asarray(logits.numpy())[:, idx]
         for idx in theirs.hierarchy_indices_list], jnp.asarray(want))
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-6)
    m = make_eval()(model, {"image": None, "label": labels}, None, False)
    hits = total = 0
    for level, idx in enumerate(theirs.hierarchy_indices_list):
        valid = want[:, level] >= 0
        pred = logits.numpy()[:, idx].argmax(-1)
        hits += int(((pred == want[:, level]) & valid).sum())
        total += int(valid.sum())
    assert float(m["acc1_correct"]) == hits and float(m["n"]) == total


def test_clis_raise_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _data(tmp_path / "data")
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    work = tmp_path / "work"
    work.mkdir()
    _recipe(work, 1, tmp_path / "data/ImageNet21K")
    for main in (cli.main, tcli.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--work-dir", str(work)])
    assert not (work / "checkpoints").exists()


def test_prepare_dataset_packs_cifar_and_a_folder(tmp_path):
    _write_cifar(tmp_path / "cifar", "cifar100")
    out = tmp_path / "c.pack"
    assert prepare_dataset.main(["pack-cifar", "--root",
                                 str(tmp_path / "cifar"), "--out",
                                 str(out)]) == 0
    jax_pack_dataset(JaxCIFAR(str(tmp_path / "cifar"), set_name="train"),
                     str(tmp_path / "j.pack"))
    assert out.read_bytes() == (tmp_path / "j.pack").read_bytes()
    _image_tree(tmp_path / "folder", ["b", "a"], per_class=2)
    assert prepare_dataset.main([
        "pack-imagefolder", "--root", str(tmp_path / "folder"), "--out",
        str(tmp_path / "f.pack"), "--size", "16", "--threads", "2"]) == 0
    r = packed.PackReader(str(tmp_path / "f.pack"))
    assert r.meta["class_names"] == ["a", "b"] and len(r) == 4
    assert r.meta["decode_failures"] == 0
    assert r.arrays["image"].shape == (4, 16, 16, 3)
    np.testing.assert_array_equal(r.arrays["label"], [0, 0, 1, 1])
