"""The device mesh and what each rank holds (counterpart of
``simpleaicv_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``('data', 'fsdp')`` mesh, shards
the global batch over both axes and lets ``jit`` insert the collectives.
The port runs one process per card under ``torch.distributed`` and keeps
the same layout as a ``DeviceMesh`` with the same two dims: rank ``r``
holds rows ``[r * B / W, (r + 1) * B / W)`` of a global batch of ``B``
rows over a world of ``W`` ranks (``batch_sharding``, ``shard_batch``),
and ``infer_param_sharding`` states, by the JAX package's rule, the
dimension of each parameter that FSDP shards over ``fsdp``
(``core.trainer`` hands it to ``fully_shard``).

The collectives the JAX partitioner derives are written out where the
port needs them; ``global_sum`` is the one they share: a sum over the
ranks that hold the batch's rows, differentiable (its backward sums the
cotangents the same way), and the identity in a world of one. A quantity
every rank computes alike from ``global_sum`` (a BatchNorm statistic, a
count that normalises a loss) then has W times its gradient on each rank,
which the engine's mean over ranks brings back.

``local``, ``full_tensor`` and ``shard_like`` move between a sharded
parameter (an FSDP2 ``DTensor``), its rank's slice and the whole tensor.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["MeshConfig", "make_mesh", "batch_sharding", "replicated",
           "infer_param_sharding", "shard_batch", "num_devices",
           "global_sum", "per_rank", "world_size", "rank", "local",
           "full_tensor", "shard_like", "RowSharding", "rows_of",
           "fsdp_shard", "sum_over_ranks", "from_rank0"]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining devices
    fsdp: int = 1
    # min number of elements before a param is sharded over fsdp
    fsdp_min_size: int = 2**16


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_devices() -> int:
    """The number of ranks (one card each)."""
    return world_size()


def make_mesh(cfg: MeshConfig = MeshConfig()):
    """A ``DeviceMesh`` of the world's ranks with dims ``("data", "fsdp")``
    (rank ``d * fsdp + f`` at ``[d, f]``), on the cards under NCCL and on
    the CPU under gloo; None in a world of one without a process group,
    where nothing is communicated."""
    n = world_size()
    fsdp = max(cfg.fsdp, 1)
    data = cfg.data if cfg.data > 0 else n // fsdp
    assert data * fsdp == n, f"mesh {data}x{fsdp} != {n} devices"
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, fsdp),
                            mesh_dim_names=("data", "fsdp"))


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Slice ``index`` of ``count`` equal slices along ``dim``."""
    index: int
    count: int
    dim: int = 0

    def apply(self, x):
        if x is None or self.count == 1:
            return x
        n = x.shape[self.dim]
        assert n % self.count == 0, (n, self.count)
        per = n // self.count
        sl = [slice(None)] * x.ndim
        sl[self.dim] = slice(self.index * per, (self.index + 1) * per)
        return x[tuple(sl)]


def _coordinate(mesh, axes):
    """(index, count) of this rank along ``axes`` of ``mesh``, the first
    axis the slowest."""
    index, count = 0, 1
    for name in axes:
        size = mesh[name].size()
        index = index * size + mesh[name].get_local_rank()
        count *= size
    return index, count


def batch_sharding(mesh, dim: int = 0,
                   axes=("data", "fsdp")) -> RowSharding:
    """The batch dim sharded over every mesh axis (data * fsdp ways): this
    rank's slice of a host-global batch."""
    if mesh is None:
        return RowSharding(0, 1, dim)
    return RowSharding(*_coordinate(mesh, axes), dim)


def replicated(mesh) -> RowSharding:
    """Every rank holds the whole tensor: the identity."""
    return RowSharding(0, 1)


def shard_batch(mesh, batch, sharding: Optional[RowSharding] = None):
    """This rank's rows of a host-global batch (a dict or a tensor), by
    ``sharding`` (default ``batch_sharding(mesh)``)."""
    sh = sharding or batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: sh.apply(v) for k, v in batch.items()}
    return sh.apply(batch)


def infer_param_sharding(mesh, model: nn.Module,
                         min_size: int = 2**16) -> Dict[str, Optional[int]]:
    """ZeRO-3-style sharding by the JAX package's rule: each parameter of at
    least ``min_size`` elements is sharded over ``fsdp`` on its largest
    dimension that the axis divides (the first of equal ones); the rest,
    and everything when ``fsdp`` is 1, stay replicated (None). Returns
    ``{name: dim or None}`` in ``named_parameters()`` order; the dims are
    the JAX package's for the port's layout of each parameter."""
    fsdp = 1 if mesh is None else mesh["fsdp"].size()
    out = {}
    for name, p in model.named_parameters():
        dim = None
        if fsdp > 1 and p.numel() >= min_size:
            for d in sorted(range(p.dim()), key=lambda d: -p.shape[d]):
                if p.shape[d] % fsdp == 0:
                    dim = d
                    break
        out[name] = dim
    return out


def fsdp_shard(model: nn.Module, mesh, min_size: int = 2**16):
    """FSDP2's ``fully_shard`` of ``model`` (on its device) over ``mesh``:
    on a ``('data', 'fsdp')`` mesh replicated over ``data`` and sharded
    over ``fsdp`` (HSDP), each parameter on the dimension
    ``infer_param_sharding`` names; the ones it leaves replicated are
    FSDP's ignored parameters, whose gradients the engine averages."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    dims = infer_param_sharding(mesh, model, min_size)
    by_id = {id(p): dims[n] for n, p in model.named_parameters()}
    ignored = {p for _, p in model.named_parameters()
               if by_id[id(p)] is None}
    return fully_shard(model, mesh=mesh, ignored_params=ignored,
                       shard_placement_fn=lambda p: Shard(by_id[id(p)]))


def sum_over_ranks(values):
    """The float64 numpy sum over the world's ranks of ``values`` (numbers
    or an array, the same shape on every rank): the eval meters'
    reduction. The values themselves in a world of one."""
    arr = np.asarray(values, dtype=np.float64)
    if world_size() == 1:
        return arr
    t = torch.from_numpy(arr.copy()).to(_backend_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def from_rank0(value: float) -> float:
    """Rank 0's ``value`` on every rank (a decision every rank must take
    alike); ``value`` itself in a world of one."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_backend_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def _backend_device() -> torch.device:
    """Where the default process group's collectives take their tensors."""
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


class _GlobalSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(t, group=None):
    """The sum of ``t`` over the ranks of ``group`` (default: the world,
    the ranks that hold the batch's rows), on every rank; its backward sums
    the cotangents over the same ranks. The identity in a world of one."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    return _GlobalSum.apply(t, group)


def per_rank(total):
    """A count over the global batch (from ``global_sum``) divided by the
    world size: a rank's own sum divided by it averages, over the ranks as
    the engine averages, to the global batch's sum over the global count.
    ``total`` itself in a world of one."""
    w = world_size()
    return total if w == 1 else total / w


def _is_dtensor(t) -> bool:
    # a DTensor exists only once its module is imported, which takes a
    # second: the check does not import it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t):
    """This rank's slice of a sharded tensor (a view that shares its
    storage); any other tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def full_tensor(t, like=None):
    """The whole of a sharded tensor ``t``, or of ``t``, this rank's slice
    of a tensor sharded as the parameter ``like`` is (a collective: every
    rank calls it). Any other tensor is returned as it is."""
    if _is_dtensor(t):
        return t.full_tensor()
    if like is not None and _is_dtensor(like):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  shape=like.shape,
                                  stride=like.stride()).full_tensor()
    return t


def shard_like(full, like):
    """This rank's slice of the whole tensor ``full`` as the parameter
    ``like`` is sharded (``full`` itself when ``like`` is not sharded)."""
    if not _is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor
    local_part = local(like)
    return distribute_tensor(full.to(local_part.device, local_part.dtype),
                             like.device_mesh, like.placements).to_local()


def rows_of(global_rows, index: int, count: int,
            accumulation_steps: int = 1):
    """The rows of global batches (``[..., B]``, the rows in the JAX
    loader's process-contiguous order) that rank ``index`` of ``count``
    takes, ``[..., B / count]``, so that its micro-batch ``i`` is its slice
    of global micro-batch ``i``: of each of the ``accumulation_steps``
    contiguous micro-batches of ``B / accumulation_steps`` rows, the rank's
    ``1 / count``. With one micro-batch, the rank's contiguous
    ``1 / count`` of the batch."""
    *lead, b = global_rows.shape
    per = b // (accumulation_steps * count)
    assert per * accumulation_steps * count == b, (b, accumulation_steps,
                                                   count)
    return global_rows.reshape(*lead, accumulation_steps, count, per)[
        ..., index, :].reshape(*lead, b // count)
