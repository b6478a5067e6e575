"""The port's DINO-DETR against the JAX package's, in f32 on the CPU, on a
tiny resnet18_dinodetr (128^2, 1 encoder and 2 decoder layers, hidden 64,
``dn_number`` 6) with seeded weights and BatchNorm statistics: the eval
forward with its top-k proposal indices, the train forward with denoising
queries (both sides fed the same four noise arrays), the denoising layout
at the reference's group counts, the weights both ways, the optimizer's
per-leaf rates for the recipe, and one engine step of the slice as a whole
(loss and gradients, then the updated parameters and statistics)."""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.core.registry import MODELS as JAX_MODELS
from simpleaicv_tpu.losses.dinodetr import DINODETRLoss as JaxDINOLoss
from simpleaicv_tpu.tasks import detection as jax_task
from simpleaicv_tpu_torch.core import engine as port_engine
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.registry import LOSSES, MODELS
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.models.common import init_params
from simpleaicv_tpu_torch.tasks.detection import make_detr_loss_fn

from _torch_port import (TINY_DINO, flatten_tree, jax_f32, one_torch_thread,
                         random_batch_stats, random_params)

IMG = 128
NAME = "resnet18_dinodetr"
OUT_KEYS = ("pred_logits", "pred_boxes", "aux_pred_logits", "aux_pred_boxes",
            "interm_pred_logits", "interm_pred_boxes")
DN_KEYS = ("dn_pred_logits", "dn_pred_boxes")
META_KEYS = ("dn_gt_index", "dn_valid", "dn_is_positive")
# the res50_dinodetr_yoloresize1024 recipe's optimizer and schedule
OPT = dict(name="AdamW", lr=1e-4, weight_decay=1e-4,
           global_weight_decay=False, sub_layer_lr={"backbone": 1e-5},
           no_weight_decay_layer_name_list=(), clip_max_norm=0.1)
SCHED = dict(scheduler="MultiStepLR", lr=1e-4, epochs=39, warm_up_epochs=0,
             gamma=0.1, milestones=(33,))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    with one_torch_thread():
        yield


def _annotations():
    """Two images with 1 and 3 boxes (cx, cy, w, h, class), padded to 4."""
    ann = np.full((2, 4, 5), -1.0, np.float32)
    ann[0, 0] = [0.5, 0.5, 0.2, 0.2, 3]
    ann[1, 0] = [0.3, 0.3, 0.1, 0.2, 1]
    ann[1, 1] = [0.7, 0.6, 0.2, 0.1, 5]
    ann[1, 2] = [0.45, 0.8, 0.3, 0.25, 7]
    return ann


def _noise(b, pad, num_classes, seed):
    """The four denoising noises as numpy arrays (flip, random class, box
    noise in [-1, 1), negative scale in [1, 2))."""
    rng = np.random.RandomState(seed)
    return (rng.rand(b, pad) < 0.25,
            rng.randint(0, num_classes, (b, pad)).astype(np.int32),
            rng.uniform(-1.0, 1.0, (b, pad, 4)).astype(np.float32),
            rng.uniform(1.0, 2.0, (b, pad, 4)).astype(np.float32))


@contextlib.contextmanager
def jax_noise(noise, topk=None):
    """Makes the JAX model draw ``noise`` and, when ``topk`` is a list,
    records its top-k proposal indices there. Only for the traces made
    inside: every jitted function is built within."""
    flip, rand_cls, box, neg = noise
    top_k = jax.lax.top_k

    def recording_top_k(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: topk.append(np.asarray(i)), idx)
        return vals, idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p, shape: jnp.asarray(flip))
        mp.setattr(jax.random, "randint",
                   lambda key, shape, lo, hi: jnp.asarray(rand_cls))
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, minval, maxval:
                   jnp.asarray(box if minval < 0 else neg))
        if topk is not None:
            mp.setattr(jax.lax, "top_k", recording_top_k)
        yield


def _port_noise(model, noise):
    """Makes the port's model draw ``noise``."""
    tensors = [torch.from_numpy(np.asarray(a)) for a in noise]
    tensors[0] = tensors[0].bool()
    model.draw_dn_noise = lambda generator, b, pad, device: tensors
    return model


@pytest.fixture(scope="module")
def dino():
    image = np.random.RandomState(0).randn(2, IMG, IMG, 3).astype(np.float32)
    ann = _annotations()
    noise = _noise(2, 2 * TINY_DINO["dn_number"], TINY_DINO["num_classes"],
                   seed=3)
    with jax_f32():
        model = JAX_MODELS.create(NAME, **TINY_DINO)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0), "dn": jax.random.PRNGKey(1)},
            jnp.asarray(image), jnp.asarray(ann), True))
        variables = {"params": random_params(shapes["params"], seed=1),
                     "batch_stats": random_batch_stats(
                         shapes["batch_stats"], seed=2)}
        eval_topk, train_topk = [], []
        with jax_noise(noise, eval_topk):
            eval_out = jax.jit(lambda v, x: model.apply(v, x, None, False))(
                variables, jnp.asarray(image))
            jax.effects_barrier()
        with jax_noise(noise, train_topk):
            train_out, new_vars = jax.jit(lambda v, x, a: model.apply(
                v, x, a, True, rngs={"dn": jax.random.PRNGKey(2)},
                mutable=["batch_stats"]))(variables, jnp.asarray(image),
                                          jnp.asarray(ann))
            jax.effects_barrier()
    return dict(model=model, variables=variables, image=image, ann=ann,
                noise=noise, eval=jax.tree.map(np.asarray, eval_out),
                eval_topk=eval_topk[0],
                train=jax.tree.map(np.asarray, train_out),
                train_topk=train_topk[0],
                train_stats=jax.tree.map(np.asarray,
                                         new_vars["batch_stats"]))


def _port_model(variables, **kwargs):
    model = MODELS.create(NAME, **TINY_DINO, dtype=torch.float32, **kwargs)
    return load_jax_params(model, variables["params"],
                           batch_stats=variables["batch_stats"])


def _close(got, want, path, tol=1e-4):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=path)


def test_eval_forward_matches_jax(dino):
    model = _port_model(dino["variables"]).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(dino["image"]))
    assert "dn_meta" not in out and "dn_pred_logits" not in out
    np.testing.assert_array_equal(out["interm_topk_index"].numpy(),
                                  dino["eval_topk"])
    for key in OUT_KEYS:
        assert out[key].shape == dino["eval"][key].shape, key
        _close(out[key].numpy(), dino["eval"][key], key)


@pytest.mark.parametrize("checkpointed", [False, True])
def test_train_forward_with_denoising_matches_jax(dino, checkpointed):
    """Train mode: batch statistics in the backbone, the denoising queries
    from the same noise, every output, the dn layout and the updated
    running statistics; with checkpointing as without."""
    model = _port_noise(_port_model(dino["variables"],
                                    use_gradient_checkpoint=checkpointed),
                        dino["noise"])
    out = model(torch.from_numpy(dino["image"]).requires_grad_(),
                torch.from_numpy(dino["ann"]), True)
    want = dino["train"]
    np.testing.assert_array_equal(out["interm_topk_index"].numpy(),
                                  dino["train_topk"])
    for key in OUT_KEYS + DN_KEYS:
        assert out[key].shape == want[key].shape, key
        _close(out[key].detach().numpy(), want[key], key)
    assert out["dn_meta"]["pad_size"] == want["dn_meta"]["pad_size"] == 12
    for key in META_KEYS:
        np.testing.assert_array_equal(out["dn_meta"][key].numpy(),
                                      want["dn_meta"][key], err_msg=key)
    sum(v.sum() for k, v in out.items()
        if k in OUT_KEYS + DN_KEYS).backward()
    got_stats = flatten_tree(export_jax_batch_stats(model))
    want_stats = flatten_tree(dino["train_stats"])
    assert set(got_stats) == set(want_stats)
    for path, w in want_stats.items():
        _close(got_stats[path], w, path)


@pytest.mark.parametrize("max_gt", [1, 40, 93])
def test_dn_dynamic_groups_at_scale(max_gt):
    """The denoising layout follows the reference's dynamic group
    arithmetic (groups = dn_number // batch-max annotations, a group 2 x
    that wide): every valid annotation gets ``groups`` positive slots;
    an image with fewer annotations shares the layout."""
    dn_number = 100
    model = MODELS.create(NAME, num_classes=8, query_nums=12,
                          encoder_layer_nums=1, decoder_layer_nums=1,
                          hidden_inplanes=64, feedforward_planes=64,
                          dn_number=dn_number, dtype=torch.float32)
    init_params(model, torch.Generator().manual_seed(0))
    ann = np.full((2, 100, 5), -1.0, np.float32)
    rng = np.random.RandomState(0)
    for j in range(max_gt):
        cx, cy = rng.rand(2) * 0.8 + 0.1
        ann[0, j] = [cx, cy, 0.1, 0.1, rng.randint(8)]
    ann[1, 0] = [0.5, 0.5, 0.2, 0.2, 1]
    with torch.no_grad():
        out = model(torch.zeros(2, 64, 64, 3), torch.from_numpy(ann), True,
                    torch.Generator().manual_seed(2))
    meta = out["dn_meta"]
    pad = meta["pad_size"]
    assert pad == 2 * dn_number
    groups, width = max(1, dn_number // max_gt), 2 * max_gt
    valid = meta["dn_valid"].numpy()
    pos = meta["dn_is_positive"].numpy()
    gt_idx = meta["dn_gt_index"].numpy()
    assert valid[0].sum() == groups * width
    counts = np.bincount(gt_idx[0][valid[0] & pos[0]], minlength=max_gt)
    assert (counts[:max_gt] == groups).all()
    assert valid[0][:width][:max_gt].all()
    assert valid[1].sum() == groups * 2
    assert (gt_idx[1][valid[1]] == 0).all()
    assert out["dn_pred_logits"].shape[2] == pad


def test_weights_round_trip(dino):
    model = _port_model(dino["variables"])
    for got, want in ((export_jax_params(model), dino["variables"]["params"]),
                      (export_jax_batch_stats(model),
                       dino["variables"]["batch_stats"])):
        got, want = flatten_tree(got), flatten_tree(want)
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg=path)
    paths = jax_paths(model)
    assert paths["label_encoder.weight"] == "label_encoder/embedding"
    assert paths["input_proj_gn.4.weight"] == "input_proj_gn_4/scale"
    assert paths["backbone.layer2.0.downsample.bn.running_var"] == \
        "batch_stats:backbone/layer2_0/downsample/bn/var"
    assert paths["decoder.1.cross_attn.sampling_offsets.weight"] == \
        "decoder_1/cross_attn/sampling_offsets/kernel"


def test_per_leaf_rates_match_jax(dino):
    """The recipe's backbone rate of 1e-5 and the weight decay reach the
    same leaves as in the JAX optimizer."""
    params = dino["variables"]["params"]
    _, _, jax_table = jax_optim.per_leaf_hyperparams(
        jax_optim.OptimizerConfig(**OPT), params)
    model = _port_model(dino["variables"])
    _, _, table = port_optim.per_leaf_hyperparams(
        port_optim.OptimizerConfig(**OPT), model)
    want = {name: (lr, wd) for name, lr, _, wd in jax_table}
    paths = jax_paths(model)
    got = {paths[name]: (lr, wd) for name, lr, _, wd in table}
    assert got == want
    assert sum(lr == 1e-5 for lr, _ in got.values()) == sum(
        "backbone" in p for p in got) > 0


# The bias of the decoder self-attention's keys shifts every score of a
# query alike and the softmax ignores it: its true gradient is 0 and both
# sides hold rounding noise there, compared at an absolute bound.
ZERO_GRAD_LEAVES = ("self_attn/k/bias",)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _step_with_grads(step, state, batch):
    """One port engine step; returns its metrics and every parameter's
    gradient as the backward left it (before clipping), in the JAX tree."""
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: grads.__setitem__(name, p.grad.clone()))
        for name, p in state.model.named_parameters()]
    _, metrics = step(state, batch)
    for hook in hooks:
        hook.remove()
    return metrics, flatten_tree(export_jax_params(state.model, grads))


def test_engine_step_matches_jax(dino):
    """One engine step of the slice with the recipe's AdamW (backbone at
    1e-5, clipping at a global norm of 0.1): the loss and its terms (1e-5
    relative), every parameter's gradient (1e-3 relative L2), then the
    parameters after the update and the running statistics. The JAX side is
    its engine's update: ``tx.update`` of the jitted loss function's
    gradients and batch statistics."""
    variables = dino["variables"]
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**OPT),
        jax_schedule.SchedulerConfig(**SCHED), 4, variables["params"])
    params = jax.tree.map(jnp.asarray, variables["params"])
    jloss = jax_task.make_detr_loss_fn(
        dino["model"], JaxDINOLoss(num_classes=TINY_DINO["num_classes"]))
    batch = {"image": dino["image"], "scaled_annots": dino["ann"]}
    with jax_f32(), jax_noise(dino["noise"]):
        (want_loss, (want_terms, new_vars)), want_grads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True), static_argnums=4)(
            params, {"batch_stats": variables["batch_stats"]},
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), True)
        want_params = jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(want_grads, params)

    model = _port_noise(_port_model(variables), dino["noise"])
    cfg = port_engine.EngineConfig()
    opt, table = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**OPT),
        port_schedule.SchedulerConfig(**SCHED), 4, model, device="cpu")
    state = port_engine.create_train_state(model, opt, cfg, device="cpu")
    step = port_engine.make_train_step(make_detr_loss_fn(LOSSES.create(
        "DINODETRLoss", num_classes=TINY_DINO["num_classes"])), cfg)
    metrics, grads = _step_with_grads(
        step, state, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert float(metrics["skipped"]) == 0.0 and opt.step_count == 1
    assert float(metrics["loss"]) == pytest.approx(float(want_loss),
                                                   rel=1e-5)
    assert set(metrics) == set(want_terms) | {"loss", "skipped"}
    assert len(want_terms) == 15
    for key, val in want_terms.items():
        assert float(metrics[key]) == pytest.approx(float(val), rel=1e-4,
                                                    abs=1e-6), key
    for path, want in flatten_tree(want_grads).items():
        if path.endswith(ZERO_GRAD_LEAVES):
            np.testing.assert_allclose(grads[path], want, atol=1e-6,
                                       err_msg=path)
            continue
        assert _rel_l2(grads[path], want) <= 1e-3, path

    # AdamW moves an element by about its leaf's rate in the first step
    # whatever the gradient's size, so an element whose gradient lies within
    # the two sides' rounding may move either way: half the rate
    paths = jax_paths(model)
    rates = {paths[name]: lr for name, lr, _, _ in table}
    got = flatten_tree(export_jax_params(model))
    for path, want in flatten_tree(want_params).items():
        np.testing.assert_allclose(got[path], np.asarray(want),
                                   atol=0.5 * rates[path], err_msg=path)
    got = flatten_tree(export_jax_batch_stats(model))
    for path, want in flatten_tree(new_vars["batch_stats"]).items():
        _close(got[path], np.asarray(want), path)
