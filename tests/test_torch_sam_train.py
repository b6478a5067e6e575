"""The port's SAM as a trained model against the JAX package's, in f32 on the
CPU on the same seeded weights and inputs: gradients of the whole tiny SAM
(flash attention on, so through the rel-pos backward) by JAX parameter path,
the three ``frozen_*`` flags, gradient checkpointing, ``forward_matting`` and
the ``train`` argument."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)

from _torch_port import TINY_SAM, flatten_tree, jax_f32, random_params

IMG = 256   # a 16x16 token grid: the global layer's 256 tokens take flash
FLAGS = [None, "frozen_image_encoder", "frozen_prompt_encoder",
         "frozen_mask_decoder"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(seed, b=2):
    """Images, a point prompt with one padding slot and a prior mask, and
    the weights of a scalar readout of (masks, ious)."""
    rng = np.random.RandomState(seed)
    points = np.concatenate([rng.rand(b, 3, 2) * IMG,
                             rng.randint(0, 2, (b, 3, 1))], -1)
    points[:, -1, 2] = -1
    return {"image": rng.rand(b, IMG, IMG, 3).astype(np.float32),
            "prompt_point": points.astype(np.float32),
            "prompt_mask": rng.randn(b, IMG // 4, IMG // 4,
                                     1).astype(np.float32),
            "w_mask": rng.randn(b, 4, IMG, IMG).astype(np.float32),
            "w_iou": rng.randn(b, 4).astype(np.float32)}


def _prompts(inp, convert):
    return {"prompt_point": convert(inp["prompt_point"]), "prompt_box": None,
            "prompt_mask": convert(inp["prompt_mask"])}


@pytest.fixture(scope="module")
def params():
    jax_model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
    inp = _inputs(0)
    with jax_f32():
        shapes = jax.eval_shape(lambda: jax_model.init(
            jax.random.PRNGKey(0), jnp.asarray(inp["image"]),
            _prompts(inp, jnp.asarray)))
    return random_params(shapes["params"], seed=1)


def _port(params, **kwargs):
    model = MODELS.create("sam_b", image_size=IMG, dtype=torch.float32,
                          **TINY_SAM, **kwargs)
    return load_jax_params(model, params)


def _port_grads(model, inp):
    model.train()
    masks, ious = model(_t(inp["image"]), _prompts(inp, _t))
    loss = (masks * _t(inp["w_mask"])).mean() + (ious * _t(inp["w_iou"])).sum()
    loss.backward()
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
             for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), flatten_tree(export_jax_params(model, grads))


def _jax_grads(params, inp, **kwargs):
    model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM, **kwargs)

    def loss_fn(p):
        masks, ious = model.apply({"params": p}, jnp.asarray(inp["image"]),
                                  _prompts(inp, jnp.asarray), (0, 1, 2, 3),
                                  True)
        return (jnp.mean(masks * inp["w_mask"]) + jnp.sum(ious * inp["w_iou"]))

    with jax_f32():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree.map(jnp.asarray, params))
    return float(loss), flatten_tree(grads)


@pytest.mark.parametrize("flag", FLAGS)
def test_sam_gradients_match_jax(params, flag):
    """Every parameter's gradient by JAX path, within 1e-4 of the tensor's
    largest gradient plus 1e-6 (f32 sums in another order through two
    encoder blocks, the flash backward and the decoder). A frozen image or
    prompt encoder leaves exactly zero gradients in that sub-tree on both
    sides; a frozen mask decoder changes nothing in the model (it is frozen
    at the optimizer)."""
    kwargs = {} if flag is None else {flag: True}
    inp = _inputs(2)
    want_loss, want = _jax_grads(params, inp, **kwargs)
    got_loss, got = _port_grads(_port(params, **kwargs), inp)
    assert got_loss == pytest.approx(want_loss, abs=1e-4)
    # the port keeps the fixed gaussian projection as a buffer: no gradient
    buffer = "prompt_encoder/pe_layer/positional_encoding_gaussian_matrix"
    assert set(got) == set(want) - {buffer}
    assert not np.any(want[buffer])
    for path, g in got.items():
        w = want[path]
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=path)
    frozen = {"frozen_image_encoder": "image_encoder/",
              "frozen_prompt_encoder": "prompt_encoder/"}.get(flag)
    live = [path for path, g in got.items() if np.any(g)]
    if frozen is not None:
        assert not [p for p in live if p.startswith(frozen)]
    for root in {"image_encoder/", "prompt_encoder/",
                 "mask_decoder/"} - {frozen}:
        assert [p for p in live if p.startswith(root)], root


def test_frozen_flags_leave_the_forward_alone(params):
    inp = _inputs(3, b=1)
    with torch.no_grad():
        want = _port(params).eval()(_t(inp["image"]), _prompts(inp, _t))
        for flag in FLAGS[1:]:
            got = _port(params, **{flag: True}).eval()(
                _t(inp["image"]), _prompts(inp, _t))
            for a, b in zip(got, want):
                assert torch.equal(a, b), flag


def test_gradient_checkpointing_gives_equal_gradients(params):
    """Each encoder block is recomputed in the backward, in train mode only;
    the gradients are those of the plain backward."""
    inp = _inputs(4)
    plain, remat = _port(params), _port(params, use_gradient_checkpoint=True)
    assert remat.image_encoder.use_gradient_checkpoint
    loss_a, want = _port_grads(plain, inp)
    loss_b, got = _port_grads(remat, inp)
    assert loss_a == loss_b
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-7, rtol=1e-6,
                                   err_msg=path)
    # eval mode and no_grad take the blocks directly
    calls = []
    remat.image_encoder.blocks[0].register_forward_hook(
        lambda *a: calls.append(torch.is_grad_enabled()))
    remat.eval()
    remat(_t(inp["image"]), _prompts(inp, _t))[0].sum().backward()
    assert calls == [True]  # one call: nothing was recomputed


def test_forward_matting_matches_jax(params):
    inp = _inputs(5)
    jax_model = JAX_MODELS.create("sam_b", image_size=IMG, **TINY_SAM)
    with jax_f32():
        want = jax.jit(lambda p, x, pr: jax_model.apply(
            {"params": p}, x, pr, False,
            method=type(jax_model).forward_matting))(
            params, jnp.asarray(inp["image"]), _prompts(inp, jnp.asarray))
    with torch.no_grad():
        got = _port(params).eval().forward_matting(_t(inp["image"]),
                                                   _prompts(inp, _t))
    g = IMG // 16
    assert [tuple(t.shape) for t in got] == [
        (2, 4, 4 * g, 4 * g), (2, 4), (2, g, g, 64), (2, 4 * g, 4 * g, 8)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3)


def test_train_argument_sets_the_mode(params):
    """``train`` stands where the JAX ``__call__`` has it: True and False
    set the module's mode for that call, None leaves it alone, and the mode
    the caller set is back afterwards."""
    model = _port(params).eval()
    inp = _inputs(6, b=1)
    args = (_t(inp["image"]), _prompts(inp, _t), (0,))
    seen = []
    model.image_encoder.register_forward_hook(
        lambda module, *_: seen.append(module.training))
    with torch.no_grad():
        model(*args)
        model(*args, True)
        assert not model.training and not model.image_encoder.training
        model(*args, train=False)
        assert model.encode_image(args[0], train=True).shape == (1, 16, 16,
                                                                 64)
        assert not model.training
        model.train()
        model(*args, train=False)
        model.forward_matting(*args[:2], train=False)
        model(*args)
        assert model.training and model.image_encoder.training
    assert seen == [False, True, False, True, False, False, True]


def test_jax_paths_cover_every_sam_parameter(params):
    """The weight bridge both ways: every leaf of the JAX tree has one key of
    the port's state_dict, and exporting gives the tree back bit for bit."""
    model = _port(params)
    paths = jax_paths(model)
    flat = flatten_tree(params)
    assert sorted(paths.values()) == sorted(flat)
    assert set(paths) == set(model.state_dict())
    back = flatten_tree(export_jax_params(model))
    for path, want in flat.items():
        np.testing.assert_array_equal(back[path], want, err_msg=path)
    with pytest.raises(KeyError, match="no tensor for port parameter"):
        export_jax_params(model, {})
    with pytest.raises(ValueError, match="no port parameter"):
        export_jax_params(model, {**model.state_dict(),
                                  "stray": torch.zeros(1)})
