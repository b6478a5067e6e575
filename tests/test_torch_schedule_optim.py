"""The port's schedules, per-parameter hyper-parameter table and optimizer
updates against the JAX package's (``core/schedule.py``, ``core/optim.py``
over optax) on the tiny ViT's parameters, with seeded numpy gradients."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simpleaicv_tpu.core import optim as jax_optim
from simpleaicv_tpu.core import schedule as jax_schedule
from simpleaicv_tpu.models.backbones.vit import ViT as JaxViT
from simpleaicv_tpu_torch.core import optim as port_optim
from simpleaicv_tpu_torch.core import schedule as port_schedule
from simpleaicv_tpu_torch.core.weights import (export_jax_params, jax_paths,
                                               load_jax_params)
from simpleaicv_tpu_torch.models.backbones.vit import ViT

from _torch_port import flatten_tree, jax_f32, random_params

TINY = dict(patch_size=8, embedding_planes=32, block_nums=3, head_nums=2,
            image_size=16, num_classes=5)


@pytest.mark.parametrize("warm_up", [0, 3])
@pytest.mark.parametrize("scheduler,extra", [
    ("CosineLR", {"min_lr": 1e-6}), ("CosineLR", {}),
    ("MultiStepLR", {"milestones": (4, 8), "gamma": 0.2}),
    ("PolyLR", {"power": 0.9, "min_lr": 1e-5})])
def test_schedule_matches_jax(scheduler, extra, warm_up):
    fields = dict(scheduler=scheduler, lr=0.05, epochs=12,
                  warm_up_epochs=warm_up, **extra)
    jcfg = jax_schedule.SchedulerConfig(**fields)
    pcfg = port_schedule.SchedulerConfig(**fields)
    grid = np.concatenate([np.linspace(0.0, 13.0, 53), [2.999, 3.0, 4.0, 8.0]])
    want = [float(jax_schedule.lr_at_epoch(jcfg, e)) for e in grid]
    got = [port_schedule.lr_at_epoch(pcfg, e) for e in grid]
    # the JAX schedule computes in f32, the port's in Python floats
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-9)
    per_step = port_schedule.lr_fn_per_step(pcfg, steps_per_epoch=7)
    want_step = jax_schedule.lr_fn_per_step(jcfg, 7)
    for step in (0, 1, 20, 50, 200):
        assert per_step(step) == pytest.approx(float(want_step(step)),
                                               rel=2e-5, abs=1e-9)


def _models(seed=0):
    with jax_f32():
        tree = jax.eval_shape(JaxViT(**TINY).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))["params"]
    params = random_params(tree, seed=seed)
    model = load_jax_params(ViT(**TINY, dtype=torch.float32), params)
    return params, model


VIT_RECIPE = dict(name="AdamW", lr=1e-3, weight_decay=0.05,
                  global_weight_decay=False,
                  no_weight_decay_layer_name_list=("position_encoding",
                                                   "cls_token"),
                  lr_layer_decay=0.75, lr_layer_decay_block_nums=3,
                  block_name="blocks")

TABLE_CASES = {
    "vit_recipe": VIT_RECIPE,
    "global_decay": dict(name="SGD", lr=0.1, weight_decay=1e-4,
                         global_weight_decay=True),
    "sub_layer": dict(name="SGD", lr=0.1, weight_decay=1e-4,
                      sub_layer_lr={"fc": 0.01, "blocks_1": 0.5},
                      sub_layer_weight_decay={"mlp": 0.0, "attn": 1e-3}),
    "frozen": dict(VIT_RECIPE, frozen_layer_name_list=("patch_embedding",
                                                       "blocks_0")),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_per_leaf_table_matches_jax(case):
    params, model = _models()
    fields = TABLE_CASES[case]
    _, _, want = jax_optim.per_leaf_hyperparams(
        jax_optim.OptimizerConfig(**fields), params)
    scales, wds, got = port_optim.per_leaf_hyperparams(
        port_optim.OptimizerConfig(**fields), model)
    want = {name: row for name, *row in want}
    paths = jax_paths(model)
    assert len(got) == len(want) == len(list(model.parameters()))
    for (name, lr, scale, wd), s in zip(got, scales):
        w_lr, w_scale, w_wd = want[paths[name]]
        assert (lr, wd) == (w_lr, w_wd), name
        assert scale == pytest.approx(w_scale, rel=1e-12), name
        frozen = any(f in paths[name]
                     for f in fields.get("frozen_layer_name_list", ()))
        assert s == (0.0 if frozen else pytest.approx(lr / fields["lr"]
                                                      * scale))
    assert wds == [row[3] for row in got]
    if case == "vit_recipe":
        by_name = {row[0]: row for row in got}
        assert by_name["cls_token"][2:] == (0.75**4, 0.0)
        assert by_name["blocks.2.mlp.fc1.weight"][2:] == (0.75, 0.05)
        assert by_name["fc.weight"][2:] == (1.0, 0.05)


UPDATE_CASES = {
    "sgd_plain": (dict(name="SGD", lr=0.1, weight_decay=1e-3, momentum=0.0),
                  dict(scheduler="MultiStepLR", lr=0.1, epochs=10,
                       milestones=(1,), gamma=0.1)),
    "sgd_momentum": (dict(name="SGD", lr=0.1, weight_decay=1e-3,
                          momentum=0.9),
                     dict(scheduler="CosineLR", lr=0.1, epochs=10)),
    "sgd_nesterov": (dict(name="SGD", lr=0.1, weight_decay=1e-3,
                          momentum=0.9, nesterov=True, clip_max_norm=0.5),
                     dict(scheduler="PolyLR", lr=0.1, epochs=10)),
    "adamw_vit_recipe": (dict(VIT_RECIPE, clip_grad_value=0.05),
                         dict(scheduler="CosineLR", lr=1e-3, epochs=10,
                              warm_up_epochs=1, min_lr=1e-6)),
    "adamw_frozen": (dict(VIT_RECIPE,
                          frozen_layer_name_list=("blocks_1", "cls_token")),
                     dict(scheduler="CosineLR", lr=1e-3, epochs=10,
                          min_lr=1e-4)),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_updates_match_optax(case):
    """Three updates from seeded gradients: parameters and moments agree
    (atol 1e-6: the per-leaf rates differ in the last f32 bit)."""
    opt_fields, sched_fields = UPDATE_CASES[case]
    params, model = _models(seed=2)
    steps_per_epoch = 2
    tx, _ = jax_optim.build_optimizer(
        jax_optim.OptimizerConfig(**opt_fields),
        jax_schedule.SchedulerConfig(**sched_fields), steps_per_epoch, params)
    opt, table = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**opt_fields),
        port_schedule.SchedulerConfig(**sched_fields), steps_per_epoch, model,
        device="cpu")
    assert table is opt.table

    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for step in range(3):
        grads = random_params(params, seed=10 + step)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = jax.tree.map(jnp.add, jparams, updates)
        port_grads = load_jax_params(ViT(**TINY, dtype=torch.float32), grads)
        opt.step([p.detach().clone() for p in port_grads.parameters()])
        assert opt.step_count == step + 1

    got, want = flatten_tree(export_jax_params(model)), flatten_tree(jparams)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-6,
                                   err_msg=path)
    names = [n for n, _ in model.named_parameters()]
    adam = [s for s in jax.tree.leaves(
        state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    if adam:
        for key, tree in (("mu", adam[0].mu), ("nu", adam[0].nu)):
            got = flatten_tree(export_jax_params(
                model, dict(zip(names, opt.moments[key]))))
            for path, w in flatten_tree(tree).items():
                np.testing.assert_allclose(got[path], w, atol=1e-7,
                                           err_msg=f"{key} {path}")
    if "frozen" in case:
        for name, p in model.named_parameters():
            if name.startswith(("blocks.1.", "cls_token")):
                assert torch.equal(p, start[name]), name
            else:
                assert not torch.equal(p, start[name]), name


def test_leaf_rates_are_not_a_multiple_of_the_base_rate():
    """Under a min_lr floor the schedule of a scaled leaf is not the scaled
    schedule, and the port follows the JAX package's per-leaf form."""
    _, model = _models()
    sched = port_schedule.SchedulerConfig("CosineLR", lr=1e-3, epochs=10,
                                          min_lr=1e-4)
    opt, _ = port_optim.build_optimizer(
        port_optim.OptimizerConfig(**VIT_RECIPE), sched, 1, model,
        device="cpu")
    lrs = dict(zip(opt.names, opt.leaf_lrs(step=9)))
    base = port_optim.current_lr(opt.cfg, sched, 1, 9)
    assert lrs["fc.weight"] == pytest.approx(base)
    scale = 0.75**4
    want = port_schedule.lr_at_epoch(
        dataclasses.replace(sched, lr=1e-3 * scale), 9.0)
    assert lrs["cls_token"] == pytest.approx(want)
    assert lrs["cls_token"] > 1.5 * scale * base  # the floor dominates


def test_unknown_optimizer_raises():
    _, model = _models()
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        port_optim.build_optimizer(
            port_optim.OptimizerConfig(name="LAMB"),
            port_schedule.SchedulerConfig(), 1, model, device="cpu")
