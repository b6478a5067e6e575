"""Every registered ConvFormer, VAN, DarkNet and CIFAR-ResNet backbone and
the ConvFormer CTC model against the JAX package's parameter tree on the
CPU (VAN's seven in ``tests/test_torch_van_variants.py``). The family
variants on VAN and ConvFormer are checked the same way in
``tests/test_torch_{van,dense,pfan,light_sam,sam_matting}_variants.py``,
with the helpers here.

Each JAX model's ``params`` and ``batch_stats`` come from ``jax.eval_shape``
of its ``init`` (as the JAX CLIs call it: LightSAM with a mask prompt, SAM
matting without), each port model is built on the meta device, and every
leaf goes through the weight bridge's layouts (``core.weights``) both ways:
JAX -> port gives the port's shape, port -> JAX the JAX shape, and no leaf
is left over on either side. Nothing is compiled and no weight is
allocated, so a full-size model costs only JAX's tracing of its ``init``
(VAN-B6 7 s, a LightSAM 3 to 4 s): names that build the same JAX model
(``face_parsing`` and ``human_parsing`` PFANs, the aliases
``convformer_m36_light_sam`` and ``convformerm36_light_sam``) share one
trace (``jax_tree``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core.registry import BACKBONES as JAX_BACKBONES
from simpleaicv_tpu.models.text_recognition import CTCModel as JaxCTCModel
from simpleaicv_tpu_torch.core import weights
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.models.text_recognition import CTCModel

from _torch_port import one_torch_thread

IMG = 64

BACKBONE_NAMES = (
    [f"convformer_{v}" for v in ("s18", "s36", "m36", "b36")]
    + [f"van_b{i}" for i in range(7)]
    + ["darknettiny", "darknet19", "darknet53"]
    + [f"resnet{d}cifar" for d in (18, 34, 50, 101, 152)])

_VAN_CONVFORMER = ("vanb0", "vanb1", "vanb2", "vanb3", "convformers18",
                   "convformers36", "convformerm36", "convformerb36")
LIGHT_SAM_NAMES = ([f"{b}_light_sam" for b in _VAN_CONVFORMER]
                   + ["convformer_m36_light_sam", "van_b3_light_sam"])
MATTING_NAMES = (["convformer_m36_sam_matting1",
                  "convformer_m36_sam_matting2"]
                 + [f"{b}_light_sam_matting{i}" for b in _VAN_CONVFORMER
                    for i in (1, 2)])
PFAN_NAMES = [f"{b}_pfan_{t}" for b in _VAN_CONVFORMER
              for t in ("segmentation", "matting", "face_parsing",
                        "human_parsing")]
DENSE_NAMES = ["convformer_m36_fcos", "van_b2_fcos", "vanb2_dbnet",
               "convformerm36_dbnet", "vanb2_solov2", "convformerm36_solov2",
               "vanb2_yolact", "convformerm36_yolact", "vanb2_deeplabv3plus",
               "convformerm36_deeplabv3plus"]

@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread(), torch.backends.mkldnn.flags(enabled=False):
        yield


_TREES = {}


def jax_tree(key, build_and_init):
    """``jax.eval_shape(build_and_init)``, once per ``key`` in a process."""
    if key not in _TREES:
        _TREES[key] = jax.eval_shape(build_and_init)
    return _TREES[key]


def _image(size=IMG, batch=1):
    return jnp.zeros((batch, size, size, 3), jnp.float32)


def _prompts(size, with_mask):
    return {"prompt_point": jnp.full((1, 9, 3), -1.0),
            "prompt_box": jnp.zeros((1, 4)),
            "prompt_mask": (jnp.zeros((1, size // 4, size // 4, 1))
                            if with_mask else None)}


def _shapes(tree, prefix=""):
    """{'a/b': shape} of a tree of ``jax.ShapeDtypeStruct``s."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if hasattr(val, "items"):
            out.update(_shapes(val, path))
        else:
            out[path] = tuple(val.shape)
    return out


def _assert_bridge(model, variables):
    """Every leaf of ``variables`` (params and batch_stats) through the
    weight bridge's layouts both ways against ``model``'s state_dict."""
    shapes = _shapes(variables["params"])
    shapes.update({weights.BATCH_STATS + p: s for p, s in
                   _shapes(variables.get("batch_stats", {})).items()})
    state = model.state_dict()
    consumed, filled = set(), set()
    for keys, paths, to_port, to_jax in weights._leaves(model, ""):
        missing = [p for p in paths if p not in shapes]
        assert not missing, (keys, missing)
        ported = to_port([np.broadcast_to(np.float32(0), shapes[p])
                          for p in paths])
        for key, arr in zip(keys, ported):
            assert arr.shape == tuple(state[key].shape), (key, arr.shape)
        for path, arr in zip(paths, to_jax(ported)):
            assert arr.shape == shapes[path], (path, arr.shape)
        consumed.update(paths)
        filled.update(keys)
    assert consumed == set(shapes), sorted(set(shapes) - consumed)[:5]
    assert filled == set(state), sorted(set(state) - filled)[:5]


def assert_sam_matting_tree(name):
    """A SAM matting variant against the JAX model, initialised as
    ``tools/train_interactive_matting.py`` initialises it (no mask
    prompt); ``convformer_m36_sam_matting{1,2}`` build the JAX package's
    ``convformerm36_light_sam_matting{1,2}`` and share their trace."""
    from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
    from simpleaicv_tpu_torch.core.registry import MODELS
    key = name.replace("convformer_m36_sam", "convformerm36_light_sam")
    jm = JAX_MODELS.create(key, image_size=IMG)
    variables = jax_tree(key, lambda: jm.init(
        jax.random.PRNGKey(0), _image(), _prompts(IMG, False), True))
    with torch.device("meta"):
        model = MODELS.create(name, image_size=IMG)
    _assert_bridge(model, variables)


def assert_backbone_tree(name):
    """A registered backbone (ten classes) against the JAX model."""
    size = 32 if "cifar" in name else IMG
    jm = JAX_BACKBONES.create(name, num_classes=10)
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               _image(size), True))
    with torch.device("meta"):
        model = BACKBONES.create(name, num_classes=10)
    _assert_bridge(model, variables)


@pytest.mark.parametrize("name", [n for n in BACKBONE_NAMES
                                  if not n.startswith("van_")])
def test_backbone_trees_match_jax(name):
    assert_backbone_tree(name)


def test_convformer_ctc_tree_matches_jax():
    jm = JaxCTCModel(backbone_type="convformer_m36", num_classes=100)
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 128, 3)), False))
    with torch.device("meta"):
        model = CTCModel(backbone_type="convformer_m36", num_classes=100)
    _assert_bridge(model, variables)
