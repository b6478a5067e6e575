"""Rank functions of the port's parallel tests, and the helper that starts
their worlds. Imports no JAX: each rank of a world is a new process that
imports this module (``parallel.multihost.run_world``), and the parent
test process holds what the ranks return to the JAX package.

Every function takes one dict of numpy arrays and plain values and returns
one; called in a process without a process group it is the port's world
of one.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from simpleaicv_tpu_torch.core.engine import (EngineConfig,
                                              average_gradients,
                                              create_train_state,
                                              make_train_step)
from simpleaicv_tpu_torch.core.optim import OptimizerConfig, build_optimizer
from simpleaicv_tpu_torch.core.registry import BACKBONES
from simpleaicv_tpu_torch.core.schedule import SchedulerConfig
from simpleaicv_tpu_torch.core.weights import (export_jax_batch_stats,
                                               export_jax_params,
                                               load_jax_params)
from simpleaicv_tpu_torch.losses.classification import (CELoss,
                                                        OneHotLabelCELoss)
from simpleaicv_tpu_torch.parallel.mesh import (MeshConfig, RowSharding,
                                                batch_sharding, fsdp_shard,
                                                full_tensor, make_mesh, rank,
                                                rows_of, shard_batch,
                                                world_size)
from simpleaicv_tpu_torch.tasks.classification import make_loss_fn

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

# one limit for every world: a hang kills the ranks and fails the test
WORLD_TIMEOUT = 60.0


def run(target: str, world: int, workdir, payload: dict):
    """``target(payload)`` on each rank of a gloo world of ``world``
    processes; the ranks' results in rank order."""
    from simpleaicv_tpu_torch.parallel.multihost import run_world
    return run_world(f"_torch_dist:{target}", world, str(workdir), (payload,),
                     backend="gloo", timeout=WORLD_TIMEOUT,
                     pythonpath=[TESTS_DIR])


def _whole(model):
    """``model``'s state dict with every sharded tensor gathered."""
    return {k: full_tensor(v).detach().clone()
            for k, v in model.state_dict().items()}


def _jax_trees(build, tensors):
    """(params, batch_stats) JAX trees of a fresh plain model from
    ``build()`` holding ``tensors``."""
    plain = build()
    plain.load_state_dict(tensors)
    return export_jax_params(plain), export_jax_batch_stats(plain)


# ---------------------------------------------------------------- ResNet-18


def _resnet18():
    return BACKBONES.create("resnet18", num_classes=10, dtype=torch.float32)


def resnet_steps(p):
    """ResNet-18 with train-mode BatchNorm through the engine: SGD,
    ``accumulation_steps``, EMA, on this rank's rows of each global batch
    (``rows_of``), FSDP2 over a ``('data', 'fsdp')`` mesh with ``fsdp``
    above 1. Returns the losses, the whole parameters, batch statistics
    and EMA in the JAX layout and, with a ``pack``, the rank's indices and
    loss of a ``PackedLoader`` batch through one more step."""
    with torch.backends.mkldnn.flags(enabled=False):
        world, r = world_size(), rank()
        fsdp = p.get("fsdp", 1) if world > 1 else 1
        mesh = make_mesh(MeshConfig(data=world // fsdp, fsdp=fsdp))
        model = load_jax_params(_resnet18(), p["params"],
                                batch_stats=p["stats"])
        if fsdp > 1:
            fsdp_shard(model, mesh, p["min_size"])
        cfg = EngineConfig(**p["engine"])
        opt, _ = build_optimizer(OptimizerConfig(**p["opt"]),
                                 SchedulerConfig(**p["sched"]), 10, model,
                                 device="cpu")
        state = create_train_state(model, opt, cfg, device="cpu")
        augment = None
        if p.get("augment"):
            from simpleaicv_tpu_torch.data.device_augment import (
                DeviceAugmentPipeline, DeviceAutoAugment, DeviceMixupCutmix)
            augment = DeviceAugmentPipeline(
                augment=DeviceAutoAugment("original"),
                mixupcutmix=DeviceMixupCutmix(num_classes=10))
        step = make_train_step(
            make_loss_fn(OneHotLabelCELoss() if augment else CELoss()), cfg,
            augment_fn=augment)
        losses = []
        for b in p["batches"]:
            rows = rows_of(np.arange(len(b["label"])), r, world,
                           cfg.accumulation_steps)
            state, m = step(state, {
                "image": torch.from_numpy(b["image"][rows]),
                "label": torch.from_numpy(b["label"][rows]).long()})
            losses.append(float(m["loss"]))
        whole = _whole(model)
        params, stats = _jax_trees(_resnet18, whole)
        out = {"losses": losses, "params": params, "stats": stats,
               "sharded": sorted(n for n, t in model.state_dict().items()
                                 if full_tensor(t) is not t)}
        if state.ema_params is not None:
            out["ema"] = export_jax_params(_resnet18(), {
                n: full_tensor(t).clone()
                for n, t in state.ema_params.items()})
        if p.get("ckpt"):
            out["resume_equal"] = _resume_equal(p, state, mesh, cfg)
        if p.get("pack"):
            from simpleaicv_tpu_torch.data.packed import PackedLoader
            loader = PackedLoader(p["pack"], len(p["batches"][0]["label"]),
                                  shuffle=True, seed=0,
                                  accumulation_steps=cfg.accumulation_steps)
            out["pack_indices"] = loader._local_indices()
            batch = next(iter(loader))
            out["pack_labels"] = batch["label"]
            state, m = step(state, {
                "image": torch.from_numpy(batch["image"].astype(np.float32)),
                "label": torch.from_numpy(batch["label"] % 10).long()})
            out["pack_loss"] = float(m["loss"])
        return out


def _resume_equal(p, state, mesh, cfg):
    """Saves ``state`` as the Trainer does (whole tensors, written by rank
    0) and restores it into a fresh sharded model and optimizer: whether
    the parameters, buffers, moments, EMA and step came back bit for
    bit."""
    from simpleaicv_tpu_torch.core.checkpoint import CheckpointManager
    ckpt = CheckpointManager(p["ckpt"])
    ckpt.save_latest(1, state, {"best_metric": 0.5}, write=rank() == 0)
    dist.barrier()
    model = load_jax_params(_resnet18(), p["params"], batch_stats=p["stats"])
    fsdp_shard(model, mesh, p["min_size"])
    opt, _ = build_optimizer(OptimizerConfig(**p["opt"]),
                             SchedulerConfig(**p["sched"]), 10, model,
                             device="cpu")
    fresh = create_train_state(model, opt, cfg, device="cpu")
    epoch, extra = ckpt.restore_latest(fresh)

    def same(a, b):
        # every rank gathers every tensor (no early exit between
        # collectives)
        return all([torch.equal(full_tensor(a[k]), full_tensor(b[k]))
                    for k in a])

    checks = [epoch == 1, extra["best_metric"] == 0.5,
              fresh.step == state.step,
              fresh.optimizer.step_count == state.optimizer.step_count,
              same(_whole(model), _whole(state.model)),
              same(fresh.ema_params, state.ema_params)]
    checks += [same(dict(zip(opt.names, fresh.optimizer.moments[k])),
                    dict(zip(opt.names, state.optimizer.moments[k])))
               for k in opt.moments]
    return all(checks)


def skip_together(p):
    """One step of ResNet-18 on a batch whose only non-finite value lies in
    the last rank's rows: whether every rank skipped it and kept its
    weights."""
    with torch.backends.mkldnn.flags(enabled=False):
        world, r = world_size(), rank()
        model = load_jax_params(_resnet18(), p["params"],
                                batch_stats=p["stats"])
        before = _whole(model)
        cfg = EngineConfig()
        opt, _ = build_optimizer(OptimizerConfig(**p["opt"]),
                                 SchedulerConfig(**p["sched"]), 10, model,
                                 device="cpu")
        state = create_train_state(model, opt, cfg, device="cpu")
        image = np.random.RandomState(9).randn(2 * world, 32, 32, 3).astype(
            np.float32)
        image[-1, 0, 0, 0] = np.inf
        rows = rows_of(np.arange(2 * world), r, world)
        state, m = make_train_step(make_loss_fn(CELoss()), cfg)(state, {
            "image": torch.from_numpy(image[rows]),
            "label": torch.zeros(2, dtype=torch.long)})
        return {"skipped": float(m["skipped"]),
                "kept": all(torch.equal(v, before[k])
                            for k, v in _whole(model).items()),
                "bad_rows_here": bool(np.isinf(image[rows]).any())}


# ---------------------------------------------------------------- ViT-S/14


def _vit_s(**kw):
    from simpleaicv_tpu_torch.models.backbones.vit import ViT
    return ViT(patch_size=14, embedding_planes=384, block_nums=2,
               head_nums=6, image_size=28, num_classes=10,
               dtype=torch.float32, **kw)


def vit_step(p):
    """ViT-S/14 (depth cut to 2) with AdamW, FSDP2 on
    ``infer_param_sharding``'s dims (``min_size``), one step of the global
    batch. Also the batch's image rows split over ``fsdp`` by
    ``shard_batch`` and gathered back: the gathered rows equal this rank's
    and give its loss."""
    world, r = world_size(), rank()
    fsdp = p.get("fsdp", 1) if world > 1 else 1
    mesh = make_mesh(MeshConfig(data=world // fsdp, fsdp=fsdp))
    model = load_jax_params(_vit_s(), p["params"])
    if fsdp > 1:
        fsdp_shard(model, mesh, p["min_size"])
    cfg = EngineConfig()
    opt, _ = build_optimizer(OptimizerConfig(**p["opt"]),
                             SchedulerConfig(**p["sched"]), 10, model,
                             device="cpu")
    state = create_train_state(model, opt, cfg, device="cpu")
    loss_fn = make_loss_fn(CELoss())
    b = p["batch"]
    rows = shard_batch(mesh, {"image": torch.from_numpy(b["image"]),
                              "label": torch.from_numpy(b["label"]).long()})
    out = {"sharded_dims": {}}
    if fsdp > 1:
        for n, t in model.named_parameters():
            placements = getattr(t, "placements", None)
            if placements is not None:
                out["sharded_dims"][n] = [pl.dim for pl in placements
                                          if pl.is_shard()][0]
        # the batch over data and the image rows (H) over fsdp, gathered
        # back over the fsdp group
        mine = shard_batch(mesh, {k: torch.from_numpy(v) for k, v in
                                  b.items()},
                           batch_sharding(mesh, axes=("data",)))
        part = shard_batch(mesh, mine["image"], batch_sharding(
            mesh, dim=1, axes=("fsdp",)))
        parts = [torch.empty_like(part) for _ in range(fsdp)]
        dist.all_gather(parts, part.contiguous(),
                        group=mesh["fsdp"].get_group())
        gathered = torch.cat(parts, dim=1)
        out["gathered_equal"] = bool(torch.equal(gathered, mine["image"]))
        mine["label"] = mine["label"].long()
        with torch.no_grad():
            model.eval()
            out["gathered_loss"] = float(loss_fn(
                model, {"image": gathered, "label": mine["label"]}, None,
                False)[0])
            out["row_loss"] = float(loss_fn(model, mine, None, False)[0])
    # the global norm of the sharded gradient: each rank's slices' squares
    # summed over the ranks that shard them
    from simpleaicv_tpu_torch.core.optim import global_norm
    model.train()
    loss_fn(model, rows, None, True)[0].backward()
    grads = [q.grad for q in model.parameters()]
    out["norm"] = float(global_norm(grads))
    out["norm_whole"] = float(torch.sqrt(sum(
        full_tensor(g).double().square().sum() for g in grads)))
    for q in model.parameters():
        q.grad = None
    state, m = make_train_step(loss_fn, cfg)(state, rows)
    out["loss"] = float(m["loss"])
    out["params"] = export_jax_params(_vit_s(), _whole(model))
    return out




def dp_world(p):
    """Data parallel legs on one world: the ResNet-18 steps, the same with
    device augmentation, and the count-normalised detection losses."""
    return {"resnet": resnet_steps(p["resnet"]),
            "augment": resnet_steps({**p["resnet"], "augment": True,
                                     "batches": p["augment_batches"]}),
            "fcos": fcos_loss(p["fcos"]),
            "skip": skip_together(p["resnet"])}


# ---------------------------------------------------------------- FCOS loss


def fcos_loss(p):
    """The FCOS loss (its terms divide by the positives of the global
    batch) and its gradients of this rank's rows of drawn predictions."""
    from simpleaicv_tpu_torch.losses.detection import FCOSLoss
    world, r = world_size(), rank()
    rows = rows_of(np.arange(p["annotations"].shape[0]), r, world)
    cls = [torch.tensor(c[rows], requires_grad=True) for c in p["cls"]]
    reg = [torch.tensor(c[rows], requires_grad=True) for c in p["reg"]]
    ctr = [torch.tensor(c[rows], requires_grad=True) for c in p["center"]]
    terms = FCOSLoss()((cls, reg, ctr),
                       torch.from_numpy(p["annotations"][rows]))
    total = sum(terms.values())
    # the engine's mean over ranks of each rank's gradient
    (total / world).backward()
    return {"terms": {k: float(v) for k, v in terms.items()},
            "grads": [t.grad.numpy() for t in cls + reg + ctr],
            "rows": rows}


# ---------------------------------------------------------------- MoE, ring


def _vit_moe():
    from simpleaicv_tpu_torch.models.backbones.vit_moe import ViTMoE
    return ViTMoE(patch_size=14, embedding_planes=32, block_nums=2,
                  head_nums=2, image_size=28, num_classes=10, num_experts=4,
                  dtype=torch.float32)


def moe_grads(p):
    """ViT-MoE with its 4 experts sharded over ``fsdp`` 2 of a ``data 2 x
    fsdp 2`` mesh: this rank's logits, the auxiliary loss, and the
    gradients of CE + 0.01 aux averaged as the engine averages them (an
    expert slice's over its replicas), each expert slice with its place."""
    from simpleaicv_tpu_torch.parallel.moe import moe_aux_loss, shard_experts
    world, r = world_size(), rank()
    model = load_jax_params(_vit_moe(), p["params"])
    mesh = make_mesh(MeshConfig(data=max(world // 2, 1),
                                fsdp=2 if world > 1 else 1))
    if world > 1:
        shard_experts(model, mesh)
    model.train()
    sh = batch_sharding(mesh)
    image = sh.apply(torch.from_numpy(p["image"]))
    label = sh.apply(torch.from_numpy(p["label"])).long()
    logits = model(image)
    aux = moe_aux_loss(model)
    (CELoss()(logits, label) + 0.01 * aux).backward()
    params = [q for _, q in model.named_parameters()]
    grads = [q.grad for q in params]
    with torch.no_grad():
        average_gradients(params, grads, 1)
    f_idx = mesh["fsdp"].get_local_rank() if world > 1 else 0
    return {"logits": logits.detach().numpy(), "aux": float(aux),
            "grads": {n: q.grad.numpy() for n, q in model.named_parameters()},
            "expert_part": f_idx,
            "expert_shapes": {n: tuple(q.shape)
                              for n, q in model.named_parameters()}}


def ring(p):
    """Ring attention over the world on this rank's sequence shard of each
    case: the output and dq, dk, dv for the cotangent ``dout``."""
    from simpleaicv_tpu_torch.parallel.ring_attention import (
        ring_attention_local)
    world, r = world_size(), rank()
    out = []
    for case in p["cases"]:
        sh = RowSharding(r, world, dim=2)
        dtype = getattr(torch, case["dtype"])
        q, k, v = (sh.apply(torch.from_numpy(case[n])).to(dtype)
                   .requires_grad_() for n in "qkv")
        o = ring_attention_local(q, k, v)
        o.float().mul(sh.apply(torch.from_numpy(case["dout"]))).sum() \
            .backward()
        out.append({"out": o.detach().float().numpy(),
                    "grads": [t.grad.float().numpy() for t in (q, k, v)]})
    return out


def moe_ring_world(p):
    return {"moe": moe_grads(p["moe"]), "ring": ring(p["ring"])}


# ---------------------------------------------------------------- pipelines


class _OneBlock(torch.nn.Module):
    """One ViT block of width 32 under the name the weight bridge knows
    (``blocks_0``)."""

    def __init__(self):
        super().__init__()
        from simpleaicv_tpu_torch.models.backbones.vit import (
            TransformerEncoderLayer)
        self.blocks = torch.nn.ModuleList(
            [TransformerEncoderLayer(32, 2, dtype=torch.float32)])

    def forward(self, x):
        return self.blocks[0](x)


def _block(params):
    return load_jax_params(_OneBlock(), {"blocks_0": params})


def gpipe_step(p):
    """The GPipe train step of one ViT block a stage (SGD 0.01, 4
    microbatches), with and without recomputation: the loss and this
    rank's stage after the step, for each."""
    from simpleaicv_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh, make_pipeline_train_step, stack_stage_params)
    mesh = make_pipeline_mesh(p["n_pipe"])

    def mse(pred, tgt):
        return ((pred - tgt)**2).mean()

    d = mesh["data"].get_local_rank()
    sh = RowSharding(d, mesh["data"].size())
    out = []
    for remat in (False, True):
        stage = stack_stage_params([_block(sp) for sp in p["stages"]], mesh)
        opt = torch.optim.SGD(stage.parameters(), lr=0.01)
        step = make_pipeline_train_step(stage, mse, opt, mesh, n_micro=4,
                                        remat=remat)
        loss = step(sh.apply(torch.from_numpy(p["x"])),
                    sh.apply(torch.from_numpy(p["y"])))
        out.append({"loss": float(loss),
                    "stage": mesh["pipe"].get_local_rank(),
                    "params": export_jax_params(stage)["blocks_0"]})
    return out


def _tiny_vit(**kw):
    from simpleaicv_tpu_torch.models.backbones.vit import ViT
    return ViT(patch_size=8, embedding_planes=32, block_nums=4, head_nums=2,
               image_size=32, num_classes=10, dtype=torch.float32, **kw)


def vit_pipeline(p):
    """``pipeline_vit``'s eval logits of each case: (pipe size, global_pool,
    flash, with a data dim); with a data dim each rank passes its data
    slice's rows."""
    from simpleaicv_tpu_torch.parallel.pipeline_vit import (
        make_vit_pipeline_apply, vit_stage_params)
    from torch.distributed.device_mesh import init_device_mesh
    world = world_size()
    out = []
    for case in p["cases"]:
        n_pipe = case["pipe"]
        mesh = init_device_mesh("cpu", (world // n_pipe, n_pipe),
                                mesh_dim_names=("data", "pipe"))
        model = load_jax_params(
            _tiny_vit(global_pool=case["global_pool"],
                      use_flash_attention=case["flash"]),
            p["params"])
        stage = vit_stage_params(model, n_pipe, mesh)
        apply = make_vit_pipeline_apply(
            model, mesh, n_micro=4,
            data_axis="data" if world // n_pipe > 1 else None)
        sh = RowSharding(mesh["data"].get_local_rank(), world // n_pipe)
        with torch.no_grad():
            logits = apply(stage, sh.apply(torch.from_numpy(p["image"])))
        out.append(logits.numpy())
    return out


def pipeline_world(p):
    return {"gpipe": gpipe_step(p["gpipe"]),
            "vit": vit_pipeline(p["vit"])}


# ---------------------------------------------------------------- Trainer


def trainer_world(p):
    """The Trainer on the recipe in ``p["work_dir"]`` with ``mesh_fsdp`` 2
    and an evaluation that does not sum over the ranks and scores each
    rank's epochs by ``p["metrics"][rank]``: the samples it read each
    evaluation, the best metric it kept, and its whole final weights."""
    from simpleaicv_tpu_torch.core.config import load_config
    from simpleaicv_tpu_torch.core.trainer import Trainer
    from simpleaicv_tpu_torch.tasks import classification
    config = load_config(p["work_dir"])
    config.mesh_fsdp = 2
    seen = []

    def evaluate(eval_step, model, loader, to_device):
        seen.append(sum(len(b["label"]) for b in loader))
        return {"key_metric": p["metrics"][rank()][len(seen) - 1]}

    trainer = Trainer(config, p["work_dir"],
                      make_loss_fn=classification.make_loss_fn,
                      make_eval_fn=classification.make_eval_fn,
                      evaluate=evaluate, device="cpu")
    best = trainer.run()
    return {"seen": seen, "best": best,
            "weights": {k: v.numpy()
                        for k, v in _whole(trainer.state.model).items()}}


def _train_classification_keeping_weights(argv):
    """The port's ``tools.train_classification`` CLI with ``argv``; then
    this rank's whole final weights go to ``rank<r>.pt`` in the work dir,
    for a test to hold the ranks to each other."""
    from simpleaicv_tpu_torch.core.trainer import Trainer
    from simpleaicv_tpu_torch.tools import train_classification
    run = Trainer.run

    def run_and_keep(self):
        best = run(self)
        torch.save(_whole(self.state.model),
                   os.path.join(self.work_dir, f"rank{rank()}.pt"))
        return best

    Trainer.run = run_and_keep
    train_classification.main(argv)


if __name__ == "__main__":
    # python -m torch.distributed.run ... tests/_torch_dist.py --work-dir D
    _train_classification_keeping_weights(sys.argv[1:])
