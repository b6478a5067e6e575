"""The port's diffusion pieces against the JAX package's, in f32 on the CPU:
the beta schedules, the UNet (unconditional and conditional) on seeded JAX
weights carried across by ``core.weights``, ``DDPMTrainer``'s loss with the
time steps and noise fed to both sides, DDPM and DDIM sampling with the JAX
samplers' own draws fed to the port, the class-label drop, and the PNG
writer against OpenCV.

JAX draws the time steps and noise inside its jitted step and sampler scan;
the port from a ``torch.Generator`` (ROADMAP queue 3). The tests take JAX's
draws (``jax.random`` replaced where it is called, or its key splits
repeated) and give them to the port.

Tolerances, unless a test says otherwise: outputs, losses and sampled
images within 1e-5 of their largest value, the schedules equal."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_tpu.core import engine as jax_engine
from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.diffusion import DDIMSampler as JaxDDIM
from simpleaicv_tpu.diffusion import DDPMSampler as JaxDDPM
from simpleaicv_tpu.diffusion import DDPMTrainer as JaxTrainer
from simpleaicv_tpu.diffusion import schedules as jax_schedules
from simpleaicv_tpu.tasks import diffusion as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.png import read_png, write_png
from simpleaicv_tpu_torch.core.registry import MODELS
from simpleaicv_tpu_torch.core.weights import export_jax_params, \
    load_jax_params
from simpleaicv_tpu_torch.diffusion import (DDIMSampler, DDPMSampler,
                                            DDPMTrainer)
from simpleaicv_tpu_torch.diffusion import schedules
from simpleaicv_tpu_torch.tasks import diffusion as port_task

from _torch_port import (assert_updates_agree, flatten_tree,
                         one_torch_thread, random_params)

S = 16
# the fake_synthetic/tiny_ddpm UNet; the conditional one with 3 classes
UNET = dict(inplanes=3, planes=32, planes_multi=(1, 2),
            time_embedding_ratio=4, block_nums=1,
            use_attention_planes_multi_idx=(1,))
CASES = {"unconditional": None, "conditional": 3}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _close(got, want, scale=None):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * (np.abs(want).max() if scale is None else scale), \
        err


@pytest.mark.parametrize("mode", ["linear", "cosine", "quad", "sqrt_linear",
                                  "const", "jsd", "sigmoid"])
def test_schedules_equal_jax(mode):
    want = jax_schedules.DiffusionConstants(mode, 50)
    got = schedules.DiffusionConstants(mode, 50)
    for key, w in vars(want).items():
        assert np.array_equal(getattr(got, key), w), key


@pytest.fixture(scope="module", params=sorted(CASES))
def unet(request):
    """(num_classes, JAX model, its variables, the jitted JAX apply, the
    port model on the same weights)."""
    classes = CASES[request.param]
    model = JAX_MODELS.create("DiffusionUNet", num_classes=classes, **UNET)
    x = jnp.zeros((2, S, S, 3))
    t = jnp.zeros((2,), jnp.int32)
    label = None if classes is None else jnp.ones((2,), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, t,
                                               label, False))
    params = random_params(shapes["params"], 1)
    apply = jax.jit(lambda x, t, cl: model.apply({"params": params}, x, t,
                                                 cl, False))
    port = load_jax_params(MODELS.create("DiffusionUNet", num_classes=classes,
                                         **UNET), params).eval()
    return classes, model, params, apply, port


def _inputs(seed, classes):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, S, S, 3).astype(np.float32)
    t = np.array([0, 7, 42, 99], np.int32)
    label = None if classes is None else np.array([0, 1, 2, 3], np.int32)
    return x, t, label


def _port_fn(port):
    return lambda x, t, cl: port(x, t, cl, False)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def test_unet_on_jax_weights(unet):
    """The predicted noise at four time steps (and, conditioned, the
    unconditional token 0 and labels 1-3), and the tree both ways."""
    classes, _, params, apply, port = unet
    x, t, label = _inputs(0, classes)
    want = apply(x, t, label)
    with torch.no_grad():
        got = port(_t(x), _t(t).long(), _t(label), False)
    _close(got, want)
    back = flatten_tree(export_jax_params(port))
    assert set(back) == set(flatten_tree(params))
    for path, w in flatten_tree(params).items():
        assert np.array_equal(back[path], w), path


def test_ddpm_trainer_loss_with_fed_draws(unet, monkeypatch):
    """DDPMTrainer at T=100 with the same t and noise on both sides (JAX's
    ``jax.random.randint`` and ``normal`` replaced): the prediction, the
    MSE and the L1 loss."""
    classes, _, _, apply, port = unet
    x, _, label = _inputs(1, classes)
    rng = np.random.RandomState(2)
    t = rng.randint(0, 100, 4).astype(np.int32)
    noise = rng.randn(*x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: jnp.asarray(noise))
    want_pred, want_noise = JaxTrainer(t=100)(apply, jnp.asarray(x),
                                              jax.random.PRNGKey(0), label)
    monkeypatch.undo()
    with torch.no_grad():
        got_pred, got_noise = DDPMTrainer(t=100)(
            _port_fn(port), _t(x), None, _t(label), t=_t(t).long(),
            noise=_t(noise))
    _close(got_noise, want_noise)
    _close(got_pred, want_pred)
    for jax_loss, port_loss in ((jax_task.MSELoss(), port_task.MSELoss()),
                                (jax_task.L1Loss(), port_task.L1Loss())):
        assert float(port_loss(got_pred, got_noise)) == pytest.approx(
            float(jax_loss(want_pred, want_noise)), rel=1e-5)


@pytest.mark.parametrize("mean_type,var_type,clip", [
    ("epsilon", "fixedsmall", True), ("epsilon", "fixedlarge", False),
    ("xstart", "fixedsmall", True), ("xprev", "fixedlarge", False)])
def test_ddpm_sampler_steps_with_fed_noise(unet, mean_type, var_type, clip):
    """Three reverse steps (t = 2, 1, 0: the last adds no noise), each
    with the noise JAX's step draws from its key."""
    classes, _, _, apply, port = unet
    x, _, label = _inputs(3, classes)
    kw = dict(t=50, mean_type=mean_type, var_type=var_type,
              clip_denoised=clip)
    jax_sampler, port_sampler = JaxDDPM(**kw), DDPMSampler(**kw)
    want, got = jnp.asarray(x), _t(x)
    for step, key in zip((2, 1, 0), jax.random.split(jax.random.PRNGKey(4),
                                                    3)):
        t = np.full((4,), step, np.int32)
        want = jax_sampler.sample_per_time_step(apply, want, jnp.asarray(t),
                                                key, label)
        noise = jax.random.normal(key, x.shape, jnp.float32)
        with torch.no_grad():
            got = port_sampler.sample_per_time_step(
                _port_fn(port), got, _t(t).long(), _t(noise), _t(label))
        _close(got, want, scale=np.abs(np.asarray(want)).max())


def _jax_scan_draws(key, shape, steps):
    """The initial images and each step's noise as the JAX samplers split
    their key."""
    key, init = jax.random.split(key)
    x = jax.random.normal(init, shape, jnp.float32)
    noise = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(step_key, shape, jnp.float32))))
    return torch.from_numpy(np.asarray(x)), noise


@pytest.mark.parametrize("sampler", ["ddpm", "ddim_uniform", "ddim_quad"])
def test_samplers_end_to_end_with_jax_draws(unet, sampler):
    """A whole reverse process (DDPM at T=8; DDIM over 4 of 20 steps at
    eta 0.5), JAX's scan against the port's loop on the JAX draws."""
    classes, _, _, apply, port = unet
    shape = (2, S, S, 3)
    label = None if classes is None else jnp.asarray([1, 2], jnp.int32)
    if sampler == "ddpm":
        jax_s, port_s, steps = JaxDDPM(t=8), DDPMSampler(t=8), 8
    else:
        kw = dict(ddpm_t=20, ddim_t=4, ddim_eta=0.5,
                  ddim_discr_method=sampler.split("_")[1])
        jax_s, port_s = JaxDDIM(**kw), DDIMSampler(**kw)
        steps = len(port_s.ddim_timesteps)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda k: jax_s(apply, shape, k, label))(key)
    x, noise = _jax_scan_draws(key, shape, steps)
    got = port_s(_port_fn(port), shape, None, _t(label), input_images=x,
                 noise=noise)
    _close(got, want)


@pytest.mark.parametrize("unet", ["conditional"], indirect=True)
def test_label_drop(unet, monkeypatch):
    """Conditional training's labels: shifted by one without a drop, all 0
    (the unconditional token) at drop probability 1, on both sides (the
    loss with the same fed t and noise); a quarter dropped at 0.25 on the
    port's generator."""
    _, model, params, _, port = unet
    rng = np.random.RandomState(6)
    batch = {"image": rng.randn(4, S, S, 3).astype(np.float32),
             "label": np.array([0, 1, 2, 0], np.int32)}
    t = rng.randint(0, 100, 4).astype(np.int32)
    noise = rng.randn(4, S, S, 3).astype(np.float32)
    for prob in (0.0, 1.0):
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(t))
        monkeypatch.setattr(jax.random, "normal",
                            lambda *a, **k: jnp.asarray(noise))
        loss_fn = jax_task.make_loss_fn(model, jax_task.MSELoss(),
                                        JaxTrainer(t=100), num_classes=3,
                                        class_label_drop_prob=prob)
        want, _ = loss_fn(params, {}, jax.tree.map(jnp.asarray, batch),
                          jax.random.PRNGKey(7), False)
        monkeypatch.undo()
        trainer = DDPMTrainer(t=100)
        monkeypatch.setattr(trainer, "draw",
                            lambda *a: (_t(t).long(), _t(noise)))
        with torch.no_grad():
            got, _ = port_task.make_loss_fn(
                port_task.MSELoss(), trainer, num_classes=3,
                class_label_drop_prob=prob)(
                port, {k: _t(v) for k, v in batch.items()},
                torch.Generator().manual_seed(0), False)
        monkeypatch.undo()
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    labels = torch.arange(40000) % 3
    dropped = port_task.drop_labels(labels, 0.25,
                                    torch.Generator().manual_seed(1))
    share = float((dropped == 0).float().mean())
    assert abs(share - 0.25) < 0.01
    kept = dropped != 0
    assert torch.equal(dropped[kept], labels[kept] + 1)


# the ddpm_learns recipe's optimizer and schedule (AdamW 2e-3, no decay,
# CosineLR over 90 epochs of 4 steps)
DDPM_OPT = dict(name="AdamW", lr=2e-3, weight_decay=0.0,
                global_weight_decay=False, no_weight_decay_layer_name_list=())
DDPM_SCHED = dict(scheduler="CosineLR", lr=2e-3, epochs=90, warm_up_epochs=0)


@pytest.mark.parametrize("unet", ["unconditional"], indirect=True)
def test_engine_steps_track_jax(unet, monkeypatch):
    """Three engine steps of the tiny DDPM recipe (cosine schedule at
    T=100, MSE) from the same weights on the same batch, with the same t
    and noise at every step on both sides (JAX's draws replaced inside its
    jitted step): each step's loss within 1e-5 relative, the parameters
    after the three steps as ``_torch_port.assert_updates_agree`` holds
    AdamW's (no element more than 2 lr apart, at most 0.5% more than lr /
    10, a cosine above 0.99)."""
    _, model, params, _, port = unet
    rng = np.random.RandomState(9)
    batch = {"image": rng.uniform(-1, 1, (4, S, S, 3)).astype(np.float32)}
    t = rng.randint(0, 100, 4).astype(np.int32)
    noise = rng.randn(4, S, S, 3).astype(np.float32)
    steps = 3

    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**DDPM_OPT),
        jax_schedule.SchedulerConfig(**DDPM_SCHED), 4, params)
    jcfg = jax_engine.EngineConfig()
    jstate = jax_engine.create_train_state(
        jax.tree.map(jnp.asarray, params), {}, tx, jcfg)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: jnp.asarray(noise))
    jstep = jax_engine.make_train_step(
        jax_task.make_loss_fn(model, jax_task.MSELoss(),
                              JaxTrainer(beta_schedule_mode="cosine",
                                         t=100)), tx, jcfg, donate=False)
    want_losses = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jax.random.PRNGKey(0))
        want_losses.append(float(jm["loss"]))
    monkeypatch.undo()

    port = load_jax_params(MODELS.create("DiffusionUNet", **UNET), params)
    trainer = DDPMTrainer(beta_schedule_mode="cosine", t=100)
    monkeypatch.setattr(trainer, "draw",
                        lambda *a: (_t(t).long(), _t(noise)))
    optimizer, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**DDPM_OPT),
        port_schedule.SchedulerConfig(**DDPM_SCHED), 4, port, device="cpu")
    state = port_engine.create_train_state(
        port, optimizer, port_engine.EngineConfig(), device="cpu")
    step = port_engine.make_train_step(
        port_task.make_loss_fn(port_task.MSELoss(), trainer),
        port_engine.EngineConfig())
    got_losses = []
    for _ in range(steps):
        state, pm = step(state, {"image": _t(batch["image"])})
        got_losses.append(float(pm["loss"]))
    assert got_losses == pytest.approx(want_losses, rel=1e-5)
    assert_updates_agree(export_jax_params(port), jstate.params, params,
                         DDPM_OPT)


def test_lecun_normal_is_flax_truncated_normal():
    """The port's seeded initialiser draws flax's ``lecun_normal``: a
    normal cut at two deviations and rescaled to 1 / sqrt(fan_in) (a plain
    normal, as the port drew before, reaches past 4 deviations in 10^5
    draws). Found on the DDPM learning recipe: over 640 samples, its mean
    distance to the nearer mode was 0.3323 with the plain normal (4
    seeds), 0.3285 with flax's (4 seeds) and 0.3285 in the JAX package."""
    from flax import linen as flax_nn

    from simpleaicv_tpu_torch.models.common import Conv2d
    conv = Conv2d(40, 250, 10)  # fan_in 4000, 10^6 draws
    conv.reset_parameters(torch.Generator().manual_seed(0))
    got = conv.weight.detach().numpy()
    want = np.asarray(flax_nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (10, 10, 40, 250)))
    assert got.std() == pytest.approx(want.std(), rel=5e-3)
    assert np.abs(got).max() == pytest.approx(np.abs(want).max(), rel=1e-3)
    assert np.abs(got).max() <= 2 / 0.87962566103423978 / np.sqrt(4000)


def test_png_writer_against_opencv(tmp_path):
    """The PNG the port writes reads back in OpenCV (BGR) and in the port's
    reader as the same pixels."""
    rng = np.random.RandomState(8)
    image = rng.randint(0, 256, (37, 21, 3)).astype(np.uint8)
    image[:5] = 17
    path = str(tmp_path / "a.png")
    write_png(path, image)
    assert np.array_equal(cv2.imread(path)[..., ::-1], image)
    assert np.array_equal(read_png(path), image)
