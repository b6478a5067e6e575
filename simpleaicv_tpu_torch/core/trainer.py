"""The training driver (counterpart of ``simpleaicv_tpu/core/trainer.py``) on
one device: the model, data, optimizer, schedule, EMA, evaluation,
checkpoints and resume of an experiment config. Task adapters provide the
loss and eval functions.

Against the JAX ``Trainer``:

* one device, the card unless the caller passes ``device="cpu"``; no mesh
  and no sharding;
* the model comes from the config and is initialised with
  ``init_params(model, torch.Generator().manual_seed(seed))`` (other numbers
  than JAX's init), then, with ``trained_model_path``, partially loaded from
  a port checkpoint;
* each batch is copied to the card from pinned host memory on a side
  stream, the next batch's copy while the current step runs;
* the loss and the learning rate are read on the host at the print
  interval only (the engine's step itself reads one finiteness flag);
* a config's ``device_augment`` (``data.device_augment``'s pipeline) is
  the engine step's ``augment_fn``, run on the card's batch before the
  forward, drawing from the step's generator;
* a ``PackedDataset`` train set goes to the ``PackedLoader`` where the JAX
  Trainer sends it there (``train_loader``);
* a config's ``moe_aux_weight`` goes to ``make_loss_fn`` (the MoE
  recipes'), as the JAX Trainer passes it.
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data.collater import ClassificationCollater
from ..data.loader import DataLoader
from ..data.packed import PackedDataset, PackedLoader
from ..models.common import init_params, resolve_device
from .checkpoint import (CheckpointManager, load_checkpoint_tensors,
                         load_state_dict_partial)
from .config import config_repr
from .engine import (EngineConfig, create_train_state, make_eval_step,
                     make_train_step)
from .logging_utils import get_logger
from .meters import AverageMeter
from .optim import OptimizerConfig, build_optimizer, current_lr
from .platform import process_index
from .schedule import SchedulerConfig

__all__ = ["Trainer", "train_loader", "optimizer_config_from_reference",
           "scheduler_config_from_reference", "batch_to_device"]


def optimizer_config_from_reference(opt_tuple) -> OptimizerConfig:
    """The reference's ('SGD' | 'AdamW', {parameters}) as an
    ``OptimizerConfig``."""
    name, p = opt_tuple
    return OptimizerConfig(
        name=name,
        lr=p["lr"],
        weight_decay=p.get("weight_decay", 0.0),
        global_weight_decay=p.get("global_weight_decay", False),
        no_weight_decay_layer_name_list=tuple(
            p.get("no_weight_decay_layer_name_list", ())),
        sub_layer_lr=p.get("sub_layer_lr"),
        sub_layer_weight_decay=p.get("sub_layer_weight_decay"),
        momentum=p.get("momentum", 0.9),
        nesterov=p.get("nesterov", False),
        beta1=p.get("beta1", 0.9),
        beta2=p.get("beta2", 0.999),
        eps=p.get("eps", 1e-8),
        lr_layer_decay=p.get("lr_layer_decay"),
        lr_layer_decay_block_nums=p.get("lr_layer_decay_block_nums"),
        block_name=p.get("block_name"),
        clip_grad_value=p.get("clip_grad_value"),
        clip_max_norm=p.get("clip_max_norm"),
        frozen_layer_name_list=tuple(p.get("frozen_layer_name_list", ())),
    )


def scheduler_config_from_reference(sched_tuple, opt_tuple,
                                    epochs: int) -> SchedulerConfig:
    name, p = sched_tuple
    return SchedulerConfig(
        scheduler=name,
        lr=opt_tuple[1]["lr"],
        epochs=epochs,
        warm_up_epochs=p.get("warm_up_epochs", 0),
        milestones=tuple(p.get("milestones", ())),
        gamma=p.get("gamma", 0.1),
        power=p.get("power", 0.9),
        min_lr=p.get("min_lr", 0.0),
    )


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The numeric entries of a host batch as tensors on ``device``; a CUDA
    copy comes from pinned memory and does not block the host. Entries that
    are no numeric array (raw text, ragged lists) stay behind."""
    out = {}
    for key, value in batch.items():
        if value is None:
            continue
        try:
            arr = np.asarray(value)
        except (ValueError, TypeError):
            continue
        if not (np.issubdtype(arr.dtype, np.number)
                or np.issubdtype(arr.dtype, np.bool_)):
            continue
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def train_loader(config, batch_size: int, workers: int, seed: int):
    """The train set's loader, chosen as the JAX Trainer chooses it
    (``simpleaicv_tpu/core/trainer.py:136-168``): a ``PackedDataset`` with
    no transform goes to the ``PackedLoader``, with its collater when that
    collater takes gathered batches (``packed_batch``), or, with no
    collater or a plain ``ClassificationCollater``, with a cast of the
    uint8 images to the collater's ``image_dtype`` (uint8, no cast, for a
    config with ``device_augment``; f32 with no collater). Everything else
    goes to the ``DataLoader``."""
    ds, tc = config.train_dataset, getattr(config, "train_collater", None)
    if isinstance(ds, PackedDataset) and ds.transform is None:
        if getattr(tc, "packed_batch", False):
            return PackedLoader(ds, batch_size, shuffle=True, drop_last=True,
                                seed=seed, n_threads=workers, collate=tc)
        if tc is None or type(tc) is ClassificationCollater:
            if tc is not None:
                target = np.dtype(tc.image_dtype)
            elif getattr(config, "device_augment", None) is not None:
                target = np.dtype(np.uint8)
            else:
                target = np.dtype(np.float32)
            collate = None
            if target != np.uint8:

                def collate(b):
                    out = dict(b)
                    out["image"] = b["image"].astype(target)
                    return out
            return PackedLoader(ds, batch_size, shuffle=True, drop_last=True,
                                seed=seed, n_threads=workers, collate=collate)
    return DataLoader(ds, batch_size, tc, shuffle=True, drop_last=True,
                      num_workers=workers, seed=seed,
                      worker_mode=getattr(config, "loader_worker_mode",
                                          "thread"))


class Trainer:

    def __init__(self, config, work_dir: str, make_loss_fn: Callable,
                 make_eval_fn: Optional[Callable] = None,
                 evaluate: Optional[Callable] = None, device="cuda"):
        self.config = config
        self.work_dir = os.path.abspath(work_dir)
        self.logger = get_logger("train", os.path.join(self.work_dir, "log"))
        self.device = resolve_device(device)

        # ---- model ----
        self.model = config.model
        self.seed = getattr(config, "seed", 0)
        np.random.seed(self.seed)
        # the transforms draw crops and flips from the global ``random``;
        # the JAX package's Trainer leaves it unseeded
        random.seed(self.seed)
        init_params(self.model, torch.Generator().manual_seed(self.seed))
        trained_path = getattr(config, "trained_model_path", "")
        if trained_path:
            tensors, n = load_state_dict_partial(
                load_checkpoint_tensors(trained_path),
                self.model.state_dict())
            self.model.load_state_dict(tensors)
            self.log(f"partially loaded {n} tensors from {trained_path}")

        # ---- data ----
        bs = config.batch_size
        workers = getattr(config, "num_workers", 4)
        self.train_loader = train_loader(config, bs, workers, self.seed)
        # `test_dataset` may be one dataset, a list or a dict {name: dataset};
        # `test_loader` is the first of `test_loaders`
        self.test_loader = None
        self.test_loaders = {}
        tds = getattr(config, "test_dataset", None)
        if tds is not None:
            if isinstance(tds, (list, tuple)):
                tds = {getattr(d, "name", f"test{i}"): d
                       for i, d in enumerate(tds)}
            if not isinstance(tds, dict):
                tds = {"test": tds}
            self.test_loaders = {
                name: DataLoader(d, bs, config.test_collater, shuffle=False,
                                 drop_last=False, num_workers=workers,
                                 seed=self.seed)
                for name, d in tds.items()}
            self.test_loader = next(iter(self.test_loaders.values()))
        self.steps_per_epoch = max(len(self.train_loader), 1)

        # ---- optimizer, schedule, engine ----
        self.opt_cfg = optimizer_config_from_reference(config.optimizer)
        self.sched_cfg = scheduler_config_from_reference(
            config.scheduler, config.optimizer, config.epochs)
        optimizer, group_table = build_optimizer(
            self.opt_cfg, self.sched_cfg, self.steps_per_epoch, self.model,
            device=self.device)
        self.log(config_repr(config))
        for name, lr, scale, wd in group_table:
            self.log(f"param {name}: lr {lr} lr_scale {scale} wd {wd}")
        self.engine_cfg = EngineConfig(
            accumulation_steps=getattr(config, "accumulation_steps", 1),
            use_ema=getattr(config, "use_ema_model", False),
            ema_decay=getattr(config, "ema_model_decay", 0.9999),
            clip_grad_value=getattr(config, "clip_grad_value", 0.0),
            clip_max_norm=getattr(config, "clip_max_norm", 0.0),
        )
        self.state = create_train_state(self.model, optimizer,
                                        self.engine_cfg, self.device)
        loss_kw = {}
        if hasattr(config, "moe_aux_weight"):  # MoE recipes only
            loss_kw["moe_aux_weight"] = config.moe_aux_weight
        self.train_step = make_train_step(
            make_loss_fn(config.train_criterion, **loss_kw), self.engine_cfg,
            augment_fn=getattr(config, "device_augment", None))
        self.eval_step = None
        self.evaluate = evaluate
        if make_eval_fn is not None:
            self.eval_step = make_eval_step(make_eval_fn(), self.device)

        # ---- checkpoints and resume ----
        self.ckpt = CheckpointManager(os.path.join(self.work_dir,
                                                   "checkpoints"))
        self.start_epoch = 1
        self.best_metric = -float("inf")
        restored = self.ckpt.restore_latest(self.state)
        if restored is not None:
            epoch, extra = restored
            self.start_epoch = epoch + 1
            self.best_metric = float(extra.get("best_metric", -float("inf")))
            self.log(f"resumed from epoch {epoch}")
        self.print_interval = getattr(config, "print_interval", 50)

    def log(self, msg: str):
        if process_index() == 0:
            self.logger.info(msg)

    def to_device(self, batch):
        return batch_to_device(batch, self.device)

    def _device_prefetch(self, loader):
        """Yields the loader's batches on the device. On a card each batch
        is copied on a side stream as soon as the loader hands it over, and
        the step's stream waits for that copy only when it takes the batch,
        so the next batch's copy overlaps the current step."""
        if self.device.type != "cuda":
            yield from (self.to_device(b) for b in loader)
            return
        copy_stream = torch.cuda.Stream(self.device)
        pending = None
        for batch in loader:
            with torch.cuda.stream(copy_stream):
                nxt = self.to_device(batch)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            if pending is not None:
                yield self._take(*pending)
            pending = (nxt, ready)
        if pending is not None:
            yield self._take(*pending)

    def _take(self, batch, ready):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for t in batch.values():
            t.record_stream(stream)  # allocated on the copy stream
        return batch

    def train_batch(self, batch) -> dict:
        """One batch on the device: one engine step; returns its metrics.
        Task trainers that take several steps a batch override it."""
        self.state, metrics = self.train_step(self.state, batch, self.seed)
        return metrics

    def train_epoch(self, epoch: int) -> float:
        self.train_loader.set_epoch(epoch)
        loss_meter = AverageMeter()
        t0 = time.time()
        n_images = 0
        for i, batch in enumerate(self._device_prefetch(self.train_loader),
                                  start=1):
            metrics = self.train_batch(batch)
            n_images += self.config.batch_size
            if i % self.print_interval == 0 or i == self.steps_per_epoch:
                loss = float(metrics["loss"])
                loss_meter.update(loss)
                lr = current_lr(self.opt_cfg, self.sched_cfg,
                                self.steps_per_epoch,
                                self.state.optimizer.step_count)
                ips = n_images / max(time.time() - t0, 1e-6)
                self.log(
                    f"epoch {epoch} iter {i}/{self.steps_per_epoch} "
                    f"loss {loss:.4f} lr {lr:.6f} imgs/s {ips:.1f}"
                    + (" [SKIPPED]" if float(metrics["skipped"]) else ""))
        return loss_meter.avg

    def eval_tensors(self) -> dict:
        """The parameters and buffers to evaluate and to keep as best: the
        EMA parameters in place of the model's when EMA is on."""
        tensors = self.state.model.state_dict()
        if self.state.ema_params is not None:
            tensors.update(self.state.ema_params)
        return tensors

    @contextlib.contextmanager
    def _eval_weights(self):
        """The model with the EMA parameters in place of its own while the
        block runs, when EMA is on."""
        ema = self.state.ema_params
        if ema is None:
            yield
            return
        params = dict(self.state.model.named_parameters())
        kept = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(kept[n])

    def run(self):
        cfg = self.config
        where = (torch.cuda.get_device_name(self.device)
                 if self.device.type == "cuda" else "cpu")
        self.log(f"device: {self.device} ({where})")
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            loss = self.train_epoch(epoch)
            key_metric = None
            # `evaluate` owns the eval pass; evaluate.needs_loader=False
            # runs without a test set
            if self.evaluate is not None and (
                    self.test_loader is not None or
                    getattr(self.evaluate, "needs_loader", True) is False):
                with self._eval_weights():
                    metrics = self.evaluate(self.eval_step, self.state.model,
                                            self.test_loader, self.to_device)
                key_metric = metrics.pop("key_metric", None)
                self.log(f"epoch {epoch} eval: {metrics}")
            if key_metric is None:
                key_metric = -loss  # loss-only tasks: lower loss = better
            if key_metric > self.best_metric:
                self.best_metric = key_metric
                if process_index() == 0:
                    self.ckpt.save_best(self.eval_tensors(), key_metric)
            if process_index() == 0:
                self.ckpt.save_latest(epoch, self.state,
                                      {"best_metric": self.best_metric,
                                       "time": time.time()})
            self.log(f"epoch {epoch} done; loss {loss:.4f} "
                     f"best {self.best_metric:.4f}")
        if process_index() == 0:
            self.ckpt.finalize_best(getattr(cfg, "network", "model"),
                                    self.best_metric)
        return self.best_metric
