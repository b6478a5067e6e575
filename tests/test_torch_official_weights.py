"""The port's official-weight conversion (``core/converters.py``,
``core/weight_convert.py``, ``tools/convert_official_weights.py``)
against the JAX package's, on the CPU.

Each family converts a seeded state dict under the official (or the
reference's) names twice: through the port's converter into a port model,
and through the JAX ``convert_official_state_dict`` + ``apply_converted``
into the JAX tree of the same model, which the weight bridge then loads
into a second port model. The two must be equal tensor for tensor (the
conversion only moves data), and every key must land. The official
models restated in ``tests/test_weight_converters.py`` also give outputs:
the port model's logits against theirs (the JAX test's bounds: cosine
0.995 and the same argmax; the restated ResNet and ViT differ from the
ported ones in their GELU and compute dtype) and against the JAX model's
on the same converted weights. The CLI then converts a checkpoint file and
``tools.test_classification`` restores it, as the
resnet50_test_convert_from_official_weight experiment does."""

import copy
import re
from pathlib import Path

import numpy as np
from PIL import Image
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from simpleaicv_tpu.core.converters import apply_converted as jax_apply
from simpleaicv_tpu.core.converters import \
    convert_official_state_dict as jax_convert
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT
from simpleaicv_tpu_torch.core.converters import (
    FAMILIES, apply_converted, convert_official_state_dict)
from simpleaicv_tpu_torch.core.registry import BACKBONES, MODELS
from simpleaicv_tpu_torch.core.weight_convert import (
    convert_torch_checkpoint, default_name_map, load_torch_state_dict)
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.models.backbones.vit import ViT
from simpleaicv_tpu_torch.models.common import Linear, init_params
from simpleaicv_tpu_torch.models.inception_v3 import InceptionV3
from simpleaicv_tpu_torch.tools import convert_official_weights as cli
from simpleaicv_tpu_torch.tools import test_classification

from _torch_port import TINY_SAM, jax_f32, one_torch_thread
from test_weight_converters import (TorchResNet50, TorchViT,
                                    _randomize_bn_stats)

REPO = Path(__file__).resolve().parent.parent
OFFICIAL_EXPERIMENT = (REPO / "experiments/0.classification_training/imagenet"
                       "/resnet50_test_convert_from_official_weight")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


def _seeded(model, seed=1):
    return init_params(model, torch.Generator().manual_seed(seed))


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _both(sd, family, model):
    """(the port's converted model and count, the JAX route's model): the
    JAX converter's tree applied onto ``model``'s own JAX tree and loaded
    back through the bridge."""
    port, n = apply_converted(copy.deepcopy(model),
                              convert_official_state_dict(sd, family))
    variables = {"params": export_jax_params(model)}
    stats = export_jax_batch_stats(model)
    if stats:
        variables["batch_stats"] = stats
    variables, _ = jax_apply(variables, jax_convert(_numpy(sd), family))
    via_jax = load_jax_params(copy.deepcopy(model), variables["params"],
                              batch_stats=variables.get("batch_stats"))
    return port, n, via_jax


def _assert_same_tensors(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def _assert_logits_agree(got, want):
    got, want = np.asarray(got), np.asarray(want)
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.995, cos
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_torchvision_resnet():
    torch.manual_seed(0)
    official = TorchResNet50(num_classes=100)
    with torch.no_grad():
        _randomize_bn_stats(official)
    official.eval()
    model = _seeded(BACKBONES.create("resnet50", num_classes=100))
    port, n, via_jax = _both(official.state_dict(), "torchvision_resnet",
                             model)
    assert n == len(model.state_dict())
    _assert_same_tensors(port, via_jax)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        _assert_logits_agree(port.eval()(x.permute(0, 2, 3, 1)),
                             official(x))


def _tiny_vit(**kw):
    return _seeded(ViT(patch_size=16, embedding_planes=64, block_nums=2,
                       head_nums=2, image_size=32, num_classes=10, **kw))


def _jax_vit_logits(model, x):
    with jax_f32():
        jax_model = JaxViT(patch_size=16, embedding_planes=64, block_nums=2,
                           head_nums=2, image_size=32, num_classes=10)
        return np.asarray(jax.jit(jax_model.apply)(
            {"params": export_jax_params(model)}, jnp.asarray(x), False))


def test_mae_vit_matches_the_official_and_the_jax_model():
    torch.manual_seed(1)
    official = TorchViT().eval()
    model = _tiny_vit(dtype=torch.float32)
    port, n, via_jax = _both(official.state_dict(), "mae_vit", model)
    assert n == len(model.state_dict())
    _assert_same_tensors(port, via_jax)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port.eval()(x)
        _assert_logits_agree(got, official(x.permute(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy(), _jax_vit_logits(port, x.numpy()),
                               rtol=0, atol=1e-5)


def test_dinov2_vit_drops_what_the_vit_lacks():
    torch.manual_seed(3)
    sd = dict(TorchViT().state_dict())
    del sd["head.weight"], sd["head.bias"]
    sd["mask_token"] = torch.zeros(1, 1, 64)
    sd["register_tokens"] = torch.zeros(1, 4, 64)
    for i in range(2):
        sd[f"blocks.{i}.ls1.gamma"] = torch.full((64,), 1e-5)
    model = _tiny_vit()
    port, n, via_jax = _both(sd, "dinov2_vit", model)
    assert n == len(model.state_dict()) - 2       # all but the classifier
    _assert_same_tensors(port, via_jax)
    assert not any("ls1" in k or "register" in k or "mask_token" in k
                   for k in convert_official_state_dict(sd, "dinov2_vit"))


def _random_state(model, seed):
    """``model``'s state dict with every tensor redrawn, variances
    positive."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.rand(v.shape, generator=g) + 0.5 if "var" in k
                else torch.randn(v.shape, generator=g))
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_convformer_params_all_land():
    """metaformer-baselines' names are the port's own; the BatchNorm
    statistics of the port's model are not in the LayerNorm checkpoints."""
    model = _seeded(BACKBONES.create("convformer_s18", num_classes=10))
    params = {k for k, _ in model.named_parameters()}
    sd = {k: v for k, v in _random_state(model, 2).items() if k in params}
    port, n, via_jax = _both(sd, "convformer", model)
    assert n == len(params)
    _assert_same_tensors(port, via_jax)
    for k in params:
        assert torch.equal(port.state_dict()[k], sd[k]), k


def test_inception_v3_every_tensor_lands():
    model = InceptionV3()
    sd = _random_state(model, 3)
    port, n, via_jax = _both(sd, "inception_v3", model)
    assert n == len(model.state_dict()) == len(sd)
    _assert_same_tensors(port, via_jax)


_SAPIENS_NAMES = [(r"^patch_embedding\.", "patch_embed.projection."),
                  (r"^position_encoding$", "pos_embed"),
                  (r"^blocks\.(\d+)\.norm1\.", r"layers.\1.ln1."),
                  (r"^blocks\.(\d+)\.norm2\.", r"layers.\1.ln2."),
                  (r"^blocks\.(\d+)\.attn\.", r"layers.\1.attn."),
                  (r"^blocks\.(\d+)\.mlp\.fc1\.", r"layers.\1.ffn.layers.0.0."),
                  (r"^blocks\.(\d+)\.mlp\.fc2\.", r"layers.\1.ffn.layers.1."),
                  (r"^norm\.", "ln1."), (r"^fc\.", "head.")]


def _renamed(sd, table, prefix=""):
    out = {}
    for key, val in sd.items():
        for pat, repl in table:
            if re.match(pat, key):
                key = re.sub(pat, repl, key)
                break
        out[prefix + key] = val
    return out


def test_sapiens_vit_renames_mmpretrain():
    model = _tiny_vit()
    sd = _renamed(_random_state(model, 4), _SAPIENS_NAMES, "backbone.")
    # the classifier sits beside the backbone
    sd = {re.sub(r"^backbone\.head\.", "head.", k): v for k, v in sd.items()}
    assert "backbone.layers.1.ffn.layers.0.0.weight" in sd
    port, n, via_jax = _both(sd, "sapiens_vit", model)
    assert n == len(model.state_dict())
    _assert_same_tensors(port, via_jax)


_REF_RESNET_NAMES = [(r"^stem\.conv\.", "conv1.layer.0."),
                     (r"^stem\.bn\.", "conv1.layer.1."),
                     (r"^(layer\d+\.\d+\.conv\d)\.conv\.", r"\1.layer.0."),
                     (r"^(layer\d+\.\d+\.conv\d)\.bn\.", r"\1.layer.1."),
                     (r"^(layer\d+\.\d+)\.downsample\.conv\.",
                      r"\1.downsample_conv.layer.0."),
                     (r"^(layer\d+\.\d+)\.downsample\.bn\.",
                      r"\1.downsample_conv.layer.1.")]


def test_ref_resnet_reads_the_reference_names():
    model = _seeded(BACKBONES.create("resnet18", num_classes=10))
    source = _random_state(model, 5)
    sd = _renamed(source, _REF_RESNET_NAMES)
    assert "layer2.0.downsample_conv.layer.1.running_var" in sd
    port, n, via_jax = _both(sd, "ref_resnet", model)
    assert n == len(source)
    _assert_same_tensors(port, via_jax)
    for key, val in source.items():
        assert torch.equal(port.state_dict()[key], val), key


def test_ref_sam_merges_the_point_embeddings():
    """SAM's reference names are the port's, but for the four one-row
    point embeddings and the embedding tables the prepass merges."""
    model = _seeded(MODELS.create("sam_b", image_size=64, dtype=torch.float32,
                                  **TINY_SAM))
    source = _random_state(model, 6)
    sd = dict(source)
    points = sd.pop("prompt_encoder.point_embeddings")
    for i in range(points.shape[0]):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = points[i:i + 1]
    for key in ("prompt_encoder.not_a_point_embed",
                "prompt_encoder.no_mask_embed"):
        sd[key + ".weight"] = sd.pop(key)[None]
    for key in ("mask_decoder.iou_token", "mask_decoder.mask_tokens"):
        sd[key + ".weight"] = sd.pop(key)
    port, n, via_jax = _both(sd, "ref_sam", model)
    assert n == len(source)
    _assert_same_tensors(port, via_jax)
    for key, val in source.items():
        assert torch.equal(port.state_dict()[key], val), key


class _Attention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.q, self.k, self.v, self.out = (Linear(c, c) for _ in range(4))


class _Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.attention = _Attention(c)


class _Encoders(nn.Module):
    """The port's DETR attention names (``encoder.0.attention.q``) and a
    bidirectional LSTM under the CTC model's ``encoder.rnn1``."""

    def __init__(self, c=8):
        super().__init__()
        self.encoder = nn.ModuleList([_Block(c)])


class _Recurrent(nn.Module):
    def __init__(self, c=6, hidden=5):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.rnn1 = nn.LSTM(c, hidden, bidirectional=True,
                                    batch_first=True)


def test_ref_detr_splits_the_packed_attention():
    torch.manual_seed(7)
    mha = nn.MultiheadAttention(8, 2)
    sd = {f"transformer.encoder_blocks.0.attention.{k}": v
          for k, v in mha.state_dict().items()}
    model = _seeded(_Encoders())
    port, n, via_jax = _both(sd, "ref_detr", model)
    assert n == len(model.state_dict()) == 8
    _assert_same_tensors(port, via_jax)
    att = port.encoder[0].attention
    w, b = mha.in_proj_weight, mha.in_proj_bias
    for i, lin in enumerate((att.q, att.k, att.v)):
        assert torch.equal(lin.weight, w[8 * i:8 * (i + 1)])
        assert torch.equal(lin.bias, b[8 * i:8 * (i + 1)])


def test_ref_ctc_joins_the_lstm_gates_and_sums_the_biases():
    torch.manual_seed(8)
    reference = _Recurrent().eval()
    model = _Recurrent()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape))
    port, n, via_jax = _both(reference.state_dict(), "ref_ctc", model)
    assert n == len(model.state_dict())
    _assert_same_tensors(port, via_jax)
    lstm = port.encoder.rnn1
    assert not lstm.bias_ih_l0.any() and not lstm.bias_ih_l0_reverse.any()
    x = torch.randn(2, 7, 6)
    with torch.no_grad():
        np.testing.assert_allclose(lstm(x)[0].numpy(),
                                   reference.encoder.rnn1(x)[0].numpy(),
                                   rtol=0, atol=1e-6)


def test_every_jax_family_has_a_port_family():
    from simpleaicv_tpu.core.converters import FAMILIES as JAX_FAMILIES
    assert set(FAMILIES) == set(JAX_FAMILIES)


def test_checkpoint_file_by_name_rules(tmp_path):
    model = _seeded(BACKBONES.create("resnet18", num_classes=10))
    source = _random_state(model, 9)
    torch.save({"model": {**source, "stem.bn.num_batches_tracked":
                          torch.tensor(3)}}, tmp_path / "ck.pth")
    assert set(load_torch_state_dict(str(tmp_path / "ck.pth"))) == \
        set(source) | {"stem.bn.num_batches_tracked"}
    assert default_name_map("stem.bn.num_batches_tracked") is None
    loaded, n = convert_torch_checkpoint(
        str(tmp_path / "ck.pth"), _seeded(BACKBONES.create(
            "resnet18", num_classes=10), seed=2))
    assert n == len(source)
    for key, val in source.items():
        assert torch.equal(loaded.state_dict()[key], val), key


def test_cli_then_test_classification(tmp_path, monkeypatch, capsys):
    """The official-weight experiment's two commands on a tiny ImageNet
    tree: convert a torchvision-named ResNet-50 checkpoint, then evaluate
    it through the test CLI from the experiment's own config."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    torch.manual_seed(0)
    official = TorchResNet50(num_classes=1000)
    ckpt = tmp_path / "resnet50-official.pth"
    torch.save(official.state_dict(), ckpt)
    cli.main(["--family", "torchvision_resnet", "--network", "resnet50",
              "--checkpoint", str(ckpt), "--out",
              str(tmp_path / "converted_resnet50")])
    total = len(_seeded(BACKBONES.create("resnet50")).state_dict())
    assert f"loaded {total}/{total} tensors" in capsys.readouterr().out

    root = tmp_path / "ILSVRC2012"
    rng = np.random.RandomState(0)
    for c in ("n01", "n02"):
        (root / "val" / c).mkdir(parents=True)
        for i in range(2):
            Image.fromarray((rng.rand(48, 56, 3) * 255).astype(np.uint8)).save(
                root / "val" / c / f"{i}.JPEG", format="JPEG")
    src = (OFFICIAL_EXPERIMENT / "test_config.py").read_text()
    for old, new in [("from path import ILSVRC2012_path  # noqa: E402",
                      f"ILSVRC2012_path = {str(root)!r}"),
                     ('trained_model_path = "./converted_resnet50"',
                      f"trained_model_path = "
                      f"{str(tmp_path / 'converted_resnet50')!r}"),
                     ("Resize(resize=256)", "Resize(resize=40)"),
                     ("input_image_size = 224", "input_image_size = 32"),
                     ("batch_size = 256", "batch_size = 4"),
                     ("num_workers = 8", "num_workers = 1")]:
        assert old in src, old
        src = src.replace(old, new)
    work = tmp_path / "work"
    work.mkdir()
    (work / "test_config.py").write_text(src)
    metrics = test_classification.main(["--work-dir", str(work)])
    assert 0.0 <= metrics["acc1"] <= 100.0
