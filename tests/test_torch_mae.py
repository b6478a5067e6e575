"""The port's MAE pretraining (``simpleaicv_tpu_torch/models/vit_mae.py``,
``losses/mae.py``, ``tasks/mae.py``, ``tools/train_mae_self_supervised.py``)
against the JAX package's on the CPU, in f32, on the same weights:

* the sin-cos position embedding, exactly;
* ``images_to_patch`` against the JAX one, exactly, and its round trip
  through ``patch_to_images``;
* the model with the JAX mask noise injected on both sides: the mask
  exactly, the predicted patches to 1e-4 of their scale;
* ``MAEMSELoss`` and ``MAEL1Loss`` to 1e-6;
* one engine step (AdamW, beta2 0.95) against the JAX step on the same
  noise, every leaf's change as ``_torch_port.assert_updates_agree`` bounds
  AdamW's first step;
* ``train_mae_self_supervised.main(argv)`` on
  ``fake_synthetic/tiny_vit_mae``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.losses import mae as jax_losses
from simpleaicv_tpu.models import vit_mae as jax_mae
from simpleaicv_tpu.tasks import mae as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.losses import mae as port_losses
from simpleaicv_tpu_torch.models import vit_mae
from simpleaicv_tpu_torch.tasks import mae as port_task
from simpleaicv_tpu_torch.tools import train_mae_self_supervised

from _torch_port import (assert_updates_agree, flatten_tree, jax_f32,
                         one_torch_thread, random_params)

REPO = Path(__file__).resolve().parent.parent
RECIPE = (REPO / "experiments/2.masked_image_modeling_training/"
          "fake_synthetic/tiny_vit_mae")
TINY = dict(patch_size=8, image_size=32, mask_ratio=0.75,
            encoder_embedding_planes=32, encoder_block_nums=2,
            encoder_head_nums=2, decoder_embedding_planes=32,
            decoder_block_nums=1, decoder_head_nums=2)
B, L = 3, 16


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _images(seed=0, n=B):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(
        np.float32)


def _noise(seed=1, n=B):
    return np.random.RandomState(seed).rand(n, L).astype(np.float32)


class _JaxNoise:
    """Makes the JAX model's mask draw ``noise``, for the calls inside."""

    def __init__(self, noise):
        self.noise = noise

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(self.noise))

    def __exit__(self, *exc):
        self.mp.undo()


@pytest.fixture(scope="module")
def pair():
    with jax_f32():
        jm = jax_mae.VITMAEPretrainModel(**TINY)
        tree = jax.eval_shape(lambda r, x: jm.init(r, x, False),
                              jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)))["params"]
    params = random_params(tree, 0)
    return jm, params


def _port(params, **kw):
    model = vit_mae.VITMAEPretrainModel(**TINY, dtype=torch.float32, **kw)
    return load_jax_params(model, params)


@pytest.mark.parametrize("dim,grid", [(32, 4), (768, 14), (512, 14)])
def test_sincos_pos_embed(dim, grid):
    np.testing.assert_array_equal(vit_mae.sincos_2d_pos_embed(dim, grid),
                                  jax_mae.sincos_2d_pos_embed(dim, grid))


def test_patchify_and_round_trip(pair):
    jm, params = pair
    x = _images()
    got = _port(params).images_to_patch(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.images_to_patch(
                                      jnp.asarray(x))))
    back = _port(params).patch_to_images(got)
    np.testing.assert_array_equal(back.numpy(), x)


def test_weights_carry_both_ways(pair):
    _, params = pair
    model = _port(params)
    paths = jax_paths(model)
    assert paths["encoder_blocks.1.attn.qkv.weight"] == \
        "encoder_blocks_1/attn/qkv/kernel"
    assert paths["mask_token"] == "mask_token"
    got = flatten_tree(export_jax_params(model))
    for path, want in flatten_tree(params).items():
        np.testing.assert_array_equal(got[path], want, err_msg=path)


@pytest.mark.parametrize("train", [True, False])
def test_model_with_injected_noise(pair, train):
    jm, params = pair
    x, noise = _images(), _noise()
    with jax_f32(), _JaxNoise(noise):
        jpred, jmask = jm.apply({"params": params}, jnp.asarray(x), train,
                                rngs={"mask": jax.random.PRNGKey(0)})
    model = _port(params).train(train)
    pred, mask = model(torch.from_numpy(x), noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.sum(dim=1).tolist() == [L - L // 4] * B
    want = np.asarray(jpred)
    assert pred.shape == (B, L, 8 * 8 * 3)
    np.testing.assert_allclose(pred.detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max())


def test_eval_mask_is_fixed_and_train_mask_follows_the_generator(pair):
    """Eval draws from a generator seeded 0 (the same mask every call);
    training from the step's generator."""
    _, params = pair
    model = _port(params).eval()
    x = torch.from_numpy(_images())
    _, m1 = model(x)
    _, m2 = model(x)
    assert torch.equal(m1, m2)
    model.train()
    g = torch.Generator().manual_seed(3)
    _, m3 = model(x, generator=g)
    _, m4 = model(x, generator=torch.Generator().manual_seed(3))
    _, m5 = model(x, generator=g)
    assert torch.equal(m3, m4) and not torch.equal(m3, m5)


# MAEL1Loss multiplies the [B, L, D] differences by the mask unreduced, so
# it takes a mask that broadcasts against them, [B, L, 1], in both packages
# (the model's [B, L] mask does not; no experiment uses the loss)
@pytest.mark.parametrize("name,mask_shape", [("MAEMSELoss", (B, L)),
                                             ("MAEL1Loss", (B, L, 1))])
def test_losses(name, mask_shape):
    rng = np.random.RandomState(5)
    pred, label = (rng.randn(B, L, 12).astype(np.float32) for _ in "ab")
    mask = (rng.rand(*mask_shape) < 0.75).astype(np.float32)
    want = getattr(jax_losses, name)()(jnp.asarray(pred), jnp.asarray(label),
                                       jnp.asarray(mask))
    got = getattr(port_losses, name)()(torch.from_numpy(pred),
                                       torch.from_numpy(label),
                                       torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_engine_step_matches_jax(pair):
    """One MAEMSELoss step, AdamW (beta2 0.95, weight decay 0.05, no decay
    on the tokens), on the same injected noise."""
    jm, params = pair
    x, noise = _images(n=4), _noise(n=4)
    opt = dict(name="AdamW", lr=6e-4, beta1=0.9, beta2=0.95,
               weight_decay=0.05,
               no_weight_decay_layer_name_list=("cls_token", "mask_token"))
    sched = dict(scheduler="CosineLR", lr=6e-4, epochs=2)
    with jax_f32(), _JaxNoise(noise):
        tx, _ = jax_optim.build_optimizer(
            jax_optim.OptimizerConfig(**opt),
            jax_schedule.SchedulerConfig(**sched), 2, params)
        jcfg = jax_engine.EngineConfig()
        jstate = jax_engine.create_train_state(
            jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
        jstep = jax_engine.make_train_step(
            jax_task.make_loss_fn(jm, jax_losses.MAEMSELoss()), tx, jcfg,
            donate=False)
        jstate, jmetrics = jstep(jstate, {"image": jnp.asarray(x)},
                                 jax.random.PRNGKey(0))

    model = _port(params)
    fixed = torch.from_numpy(noise)
    model.forward = lambda images, generator=None: \
        vit_mae.VITMAEPretrainModel.forward(model, images, generator, fixed)
    popt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt),
        port_schedule.SchedulerConfig(**sched), 2, model, device="cpu")
    pcfg = port_engine.EngineConfig()
    state = port_engine.create_train_state(model, popt, pcfg, device="cpu")
    step = port_engine.make_train_step(
        port_task.make_loss_fn(port_losses.MAEMSELoss()), pcfg)
    state, metrics = step(state, {"image": torch.from_numpy(x)})
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    assert_updates_agree(export_jax_params(model),
                         jax.tree.map(np.asarray, jstate.params), params, opt)


def test_mae_cli_on_fake_synthetic_tiny_vit_mae(tmp_path, monkeypatch):
    """The experiment's config (a ViT-B/16 encoder at 64^2, a 64-wide
    one-block decoder, 2 epochs) on 32 of its 64 samples: loss-only
    training, the best checkpoint the lowest loss."""
    monkeypatch.setenv("SIMPLEAICV_PLATFORM", "cpu")
    src = (RECIPE / "train_config.py").read_text()
    assert "num_samples=64" in src
    (tmp_path / "train_config.py").write_text(
        src.replace("num_samples=64", "num_samples=32"))
    best = train_mae_self_supervised.main(["--work-dir", str(tmp_path)])
    assert (tmp_path / "checkpoints" / "best").exists()
    log = (tmp_path / "log" / "train.log").read_text()
    losses = [float(ln.split(" loss ")[1].split()[0])
              for ln in log.splitlines() if " done; loss " in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert best == pytest.approx(-min(losses), abs=1e-4)


def test_mae_cli_raises_without_a_card(tmp_path, monkeypatch):
    """Unless the CPU is asked for, the CLI runs on the card, and raises
    where there is none."""
    monkeypatch.delenv("SIMPLEAICV_PLATFORM", raising=False)
    (tmp_path / "train_config.py").write_text(
        (RECIPE / "train_config.py").read_text())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mae_self_supervised.main(["--work-dir", str(tmp_path)])
