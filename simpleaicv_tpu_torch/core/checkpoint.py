"""Checkpoints with the JAX package's latest / best / named-final semantics
(counterpart of ``simpleaicv_tpu/core/checkpoint.py``), written with
``torch.save`` to a temporary file and renamed into place, so a reader never
sees half a file:

* ``latest/<epoch>.pt``: the full training state (the model's parameters
  and buffers, the optimizer's moments and step count, the EMA parameters,
  ``TrainState.step``), the epoch and ``extra``; the newest ``max_to_keep``
  are kept and training resumes from the newest;
* ``best``: bare parameters and buffers (the EMA parameters in place of the
  model's when EMA is on) with the metric; ``finalize_best`` links
  ``{network}-metric{metric:.3f}`` to it;
* ``load_state_dict_partial``: the name- and shape-filtered load, with a
  bicubic resize of position embeddings whose token count differs.

Saves are synchronous: an epoch's save finishes before the next epoch.
A checkpoint holds whole tensors: under FSDP2 the sharded parameters, their
moments and EMA are gathered first (a collective, so every rank calls
``save_latest`` and ``whole``, and one writes), and every rank reads the
file back into its own slices on resume.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import full_tensor, local, shard_like

__all__ = ["CheckpointManager", "load_checkpoint_tensors",
           "load_state_dict_partial"]


def _atomic_save(payload, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.latest_dir = os.path.join(self.directory, "latest")
        self.best_path = os.path.join(self.directory, "best")
        self.max_to_keep = max_to_keep
        os.makedirs(self.latest_dir, exist_ok=True)

    # -- latest (the full training state) -------------------------------
    def _epochs(self):
        return sorted(int(f[:-3]) for f in os.listdir(self.latest_dir)
                      if f.endswith(".pt") and f[:-3].isdigit())

    @staticmethod
    def whole(tensors: Optional[dict]):
        """``tensors`` with each sharded one gathered whole (every rank
        calls it)."""
        if tensors is None:
            return None
        return {k: full_tensor(v) for k, v in tensors.items()}

    def save_latest(self, epoch: int, state, extra: Optional[dict] = None,
                    write: bool = True):
        """Saves ``state`` (an engine ``TrainState``) as of the end of
        ``epoch`` and drops all but the newest ``max_to_keep``; with
        ``write`` False only gathers (the other ranks' part of a sharded
        save)."""
        payload = {"epoch": epoch, "step": state.step,
                   "model": self.whole(state.model.state_dict()),
                   "optimizer": state.optimizer.state_dict(),
                   "ema": self.whole(state.ema_params),
                   "extra": extra or {}}
        if not write:
            return
        _atomic_save(payload, os.path.join(self.latest_dir, f"{epoch}.pt"))
        for old in self._epochs()[:-self.max_to_keep]:
            os.remove(os.path.join(self.latest_dir, f"{old}.pt"))

    def restore_latest(self, state):
        """Loads the newest latest checkpoint into ``state`` in place, on
        its device; returns (epoch, extra), or None when there is none."""
        epochs = self._epochs()
        if not epochs:
            return None
        payload = torch.load(
            os.path.join(self.latest_dir, f"{epochs[-1]}.pt"),
            map_location=state.device, weights_only=True)
        if (payload["ema"] is None) != (state.ema_params is None):
            raise ValueError("the checkpoint and this run disagree on EMA")
        load_whole(state.model, payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.ema_params is not None:
            with torch.no_grad():
                for name, t in state.ema_params.items():
                    local(t).copy_(shard_like(payload["ema"][name], t))
        state.step = int(payload["step"])
        return int(payload["epoch"]), payload["extra"]

    # -- best (bare parameters and buffers) -----------------------------
    def save_best(self, tensors: dict, metric: float):
        _atomic_save({"params": tensors, "metric": float(metric)},
                     self.best_path)

    def finalize_best(self, network: str, metric: float):
        """Links ``{network}-metric{metric:.3f}`` to ``best``, as the
        reference renames its best weights to ``{network}-acc{best:.3f}``.
        A link an earlier run of the directory left (a resumed run whose
        best moved) is removed first, so that one name stands for
        ``best``, as the reference's one renamed file does."""
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(f"{network}-metric") and os.path.islink(path):
                os.unlink(path)
        named = os.path.join(self.directory, f"{network}-metric{metric:.3f}")
        if os.path.exists(self.best_path) and not os.path.exists(named):
            os.symlink(self.best_path, named)


@torch.no_grad()
def load_whole(model, tensors: dict):
    """``model.load_state_dict(tensors)`` for whole tensors, into this
    rank's slices of the parameters FSDP2 shards."""
    own = model.state_dict()
    if not any(local(v) is not v for v in own.values()):
        model.load_state_dict(tensors)
        return
    if set(own) != set(tensors):
        raise ValueError(f"checkpoint keys differ from the model's: "
                         f"{sorted(set(own) ^ set(tensors))[:5]}")
    for name, t in own.items():
        local(t).copy_(shard_like(tensors[name], t))


def load_checkpoint_tensors(path: str, map_location="cpu") -> dict:
    """The parameters and buffers in a port checkpoint: a best checkpoint's
    ``params``, a latest checkpoint's ``model``, or a bare state dict."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    for key in ("params", "model"):
        if isinstance(payload, dict) and isinstance(payload.get(key), dict):
            return payload[key]
    return payload


def load_state_dict_partial(saved: dict, target: dict,
                            pos_embed_names=("position_encoding",)):
    """(state dict, count loaded): ``target`` with each tensor of ``saved``
    that has the same name and shape put in its place, cast to the target's
    dtype; a 3-D position embedding ``[1, 1 + N, C]`` whose name holds one
    of ``pos_embed_names`` and whose token count differs is resized
    bicubically to the target's (the class token kept)."""
    out = dict(target)
    n_loaded = 0
    for k, v in saved.items():
        if k not in target:
            continue
        tgt = target[k]
        if v.shape == tgt.shape:
            out[k] = v.to(tgt.dtype)
            n_loaded += 1
        elif (any(name in k for name in pos_embed_names) and v.dim() == 3
              and tgt.dim() == 3 and v.shape[-1] == tgt.shape[-1]):
            out[k] = _resize_pos_embed(v, tgt.shape).to(tgt.dtype)
            n_loaded += 1
    return out, n_loaded


def _resize_pos_embed(pos, target_shape):
    """[1, 1 + N, C] -> [1, 1 + M, C]: the square grid of N tokens resized
    to M by bicubic interpolation at pixel centres (OpenCV's
    ``INTER_CUBIC``), the class token kept."""
    side_src = int(round((pos.shape[1] - 1)**0.5))
    side_tgt = int(round((target_shape[1] - 1)**0.5))
    cls_tok, grid = pos[:, :1], pos[:, 1:].float()
    grid = grid.reshape(1, side_src, side_src, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(side_tgt, side_tgt), mode="bicubic",
                         align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, side_tgt * side_tgt, -1)
    return torch.cat([cls_tok.float(), grid], dim=1)
