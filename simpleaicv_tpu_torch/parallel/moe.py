"""Token-routed Mixture-of-Experts feed-forward (counterpart of
``simpleaicv_tpu/parallel/moe.py``): GShard/Switch top-k routing with a
fixed expert capacity, tokens past it dropped, and the Switch load-balance
loss plus the ST-MoE router z-loss.

The JAX package expresses routing as one-hot ``[T, E, Cap]`` dispatch and
combine tensors and einsums (gather-free, for the TPU). At ViT-MoE-B/16's
recipe (batch 128, 224^2, 8 experts, top-2, capacity factor 1.25) one such
f32 tensor is 6.36 GB, and a layer's dispatch, combine and cast about 16 GB.
The port computes the same routing from the same order without them:

* the same argmax per choice (``torch.argmax`` takes the first maximum, as
  ``jnp.argmax`` does), masking the chosen expert's probability to 0;
* each choice's position inside its expert's buffer from a cumulative sum
  over tokens in (batch, token) order, slot-0 choices before slot-1 ones,
  the offset carried between them; positions are integers, exact;
* the kept rows gathered into ``[E, Cap, C]`` expert buffers (an exact
  copy of the compute-dtype rows), the experts' FFNs as batched products,
  and the combine as a gather of each token's kept rows times their gates,
  summed in f32 (at most ``top_k`` terms); a dropped choice has gate 0.

``top_k_dispatch`` keeps the one-hot form, by the JAX package's formula, as
a plain function for the tests; nothing on the model's path calls it.

The expert products take compute-dtype operands and give f32 results, as
the JAX einsums' ``preferred_element_type=f32``: on a CUDA card through
``torch.bmm(..., out_dtype=torch.float32)`` (cuBLAS, bf16 operands and f32
accumulation and output), elsewhere on f32 copies of the operands (the same
products: a product of two bf16 values is exact in f32). Their backward
keeps the f32 output gradient in f32 and rounds only its results to the
compute dtype, as the einsums' transpose in JAX does (``_f32_parts``).

The auxiliary loss is not sown into a collection: each ``MoEFeedForward``
keeps the value of its last forward in ``aux_loss``, and ``moe_aux_loss``
sums them over a model.

In a world of several ranks the routing is the global batch's, as the JAX
package's on a mesh: the capacity comes from the global token count, the
positions run over the ranks' tokens in rank order (one ``all_reduce`` of
each rank's per-expert counts), and the load-balance and z terms are means
over the global tokens (``parallel.mesh.global_sum``). With the expert
stacks sharded (``shard_experts``: ``wi``/``bi``/``wo``/``bo`` split on
their leading ``[E]`` dim over the mesh's ``fsdp`` dim, as
``expert_param_sharding`` states), each kept choice's row is sent to the
rank that owns its expert with ``all_to_all_single`` and its output comes
back the same way (the all-to-all that the JAX partitioner derives from the
dispatch and combine einsums); with them replicated, each rank runs its own
rows. ``dispatch`` and ``combine`` serve the world of one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist

from ..models.common import _lecun_normal, truncated_normal_
from .mesh import global_sum, world_size

__all__ = ["top_k_dispatch", "top_k_route", "dispatch", "combine",
           "MoEFeedForward", "moe_aux_loss", "expert_param_sharding",
           "shard_experts"]

_EXPERT_LEAVES = ("wi", "bi", "wo", "bo")


def _choices(probs, top_k: int):
    """Per choice: the expert index [T] and the one-hot mask [T, E] (f32),
    the probability masking of the JAX package's loop."""
    e = probs.shape[1]
    idxs, masks = [], []
    p = probs
    for _ in range(top_k):
        idx = torch.argmax(p, dim=-1)
        m = F.one_hot(idx, e).to(probs.dtype)
        idxs.append(idx)
        masks.append(m)
        p = p * (1.0 - m)
    return idxs, masks


def _aux_and_gates(probs, idxs, masks, top_k: int):
    e = probs.shape[1]
    # the load-balance loss from the top-1 assignment (Switch eq. 4-6)
    frac_tokens = masks[0].mean(dim=0)
    aux = e * (frac_tokens * probs.mean(dim=0)).sum()
    gates = [probs.gather(1, idx[:, None])[:, 0] for idx in idxs]
    if top_k > 1:
        denom = sum(gates)
        gates = [g / torch.clamp(denom, min=1e-9) for g in gates]
    return aux, gates


def _positions(masks, idxs, starts=None):
    """Each choice's slot inside its expert's buffer [T] (int64): tokens
    earlier in the batch, and earlier choices, fill slots first. The count
    runs along the tokens of an [E, T] copy of each mask, the contiguous
    dimension (a sum down the T rows of 8 columns took 4.3 ms a call on
    the card at T 25,216). ``starts`` [K, E] (int32), when given, is each
    choice's first slot in each expert (a rank's place among the global
    batch's); by default each choice starts where the previous ones of
    these tokens ended."""
    e = masks[0].shape[1]
    offset = torch.zeros(e, 1, dtype=torch.int32, device=masks[0].device)
    out = []
    for k, (m, idx) in enumerate(zip(masks, idxs)):
        if starts is not None:
            offset = starts[k][:, None]
        mt = m.t().to(torch.int32).contiguous()          # [E, T]
        before = torch.cumsum(mt, dim=1, dtype=torch.int32) - mt + offset
        out.append(before.gather(0, idx[None, :])[0].to(torch.int64))
        offset = offset + mt.sum(dim=1, keepdim=True, dtype=torch.int32)
    return out


def _global_starts(masks):
    """[K, E] int32: where this rank's choices of each kind start in each
    expert's buffer of the global batch, whose tokens are the ranks' in
    rank order and whose first choices all come before its second ones
    (one ``all_reduce`` of the ranks' per-expert counts)."""
    w, r = world_size(), dist.get_rank()
    counts = torch.zeros(w, len(masks), masks[0].shape[1], dtype=torch.int64,
                         device=masks[0].device)
    counts[r] = torch.stack([m.sum(dim=0) for m in masks]).to(torch.int64)
    dist.all_reduce(counts)
    totals = counts.sum(dim=0)                           # [K, E]
    earlier_kinds = torch.cumsum(totals, dim=0) - totals
    earlier_ranks = counts[:r].sum(dim=0)
    return (earlier_kinds + earlier_ranks).to(torch.int32)


def _global_route(logits, probs, capacity: int, top_k: int,
                  z_weight: float, tokens: int):
    """``top_k_route`` (and the z-loss) of this rank's tokens as part of the
    global batch of ``tokens`` tokens: global positions and global means in
    the auxiliary terms."""
    e = probs.shape[1]
    idxs, masks = _choices(probs, top_k)
    stats = [masks[0].sum(dim=0), probs.sum(dim=0)]
    if z_weight > 0.0:
        stats.append(torch.logsumexp(logits, dim=-1).square().sum()[None])
    stats = global_sum(torch.cat(stats)) / tokens
    aux = e * (stats[:e] * stats[e:2 * e]).sum()
    if z_weight > 0.0:
        aux = aux + z_weight * stats[2 * e]
    gates = [probs.gather(1, idx[:, None])[:, 0] for idx in idxs]
    if top_k > 1:
        denom = sum(gates)
        gates = [g / torch.clamp(denom, min=1e-9) for g in gates]
    slots, kept_gates = [], []
    for idx, pos, g in zip(idxs, _positions(masks, idxs,
                                            _global_starts(masks)), gates):
        keep = pos < capacity
        slots.append(torch.where(keep, idx * capacity + pos,
                                 torch.full_like(pos, -1)))
        kept_gates.append(g * keep.to(g.dtype))
    return slots, kept_gates, aux


def top_k_route(probs, capacity: int, top_k: int):
    """The routing without ``[T, E, Cap]`` tensors.

    probs: [T, E] router softmax (f32). Returns (slots, gates, aux): per
    choice, ``slots[k]`` [T] is the row ``expert * capacity + position`` of
    the expert buffers, or -1 where the choice was dropped (past capacity),
    and ``gates[k]`` [T] its gate (renormalised over the choices for
    ``top_k > 1``, 0 where dropped); ``aux`` is the load-balance loss.
    """
    idxs, masks = _choices(probs, top_k)
    aux, gates = _aux_and_gates(probs, idxs, masks, top_k)
    slots, kept_gates = [], []
    for idx, pos, g in zip(idxs, _positions(masks, idxs), gates):
        keep = pos < capacity
        slots.append(torch.where(keep, idx * capacity + pos,
                                 torch.full_like(pos, -1)))
        kept_gates.append(g * keep.to(g.dtype))
    return slots, kept_gates, aux


def top_k_dispatch(probs, capacity: int, top_k: int):
    """The JAX package's one-hot form, by its own formula: (dispatch [T, E,
    Cap] 0/1, combine [T, E, Cap] gated, aux), the positions from an f32
    cumulative sum down the [T, E] masks and their one-hot over the
    capacity. It shares no code with ``top_k_route``, so the tests and the
    card can hold the index form against it; the model never calls it."""
    t, e = probs.shape
    masks, gates = [], []
    p = probs
    for _ in range(top_k):
        m = F.one_hot(torch.argmax(p, dim=-1), e).to(probs.dtype)
        masks.append(m)
        gates.append((probs * m).sum(dim=-1))
        p = p * (1.0 - m)
    aux = e * (masks[0].mean(dim=0) * probs.mean(dim=0)).sum()
    if top_k > 1:
        denom = sum(gates)
        gates = [g / torch.clamp(denom, min=1e-9) for g in gates]
    dispatch = probs.new_zeros(t, e, capacity)
    combine = probs.new_zeros(t, e, capacity)
    offset = probs.new_zeros(e)
    cells = torch.arange(capacity, device=probs.device)
    for m, g in zip(masks, gates):
        pos = ((torch.cumsum(m, dim=0) - m + offset) * m).sum(dim=-1)
        keep = m.sum(dim=-1) * (pos < capacity).to(m.dtype)
        slot = (pos.to(torch.int64)[:, None] == cells).to(m.dtype)
        d = (keep[:, None] * m)[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d
        combine = combine + g[:, None, None] * d
        offset = offset + m.sum(dim=0)
    return dispatch, combine, aux


def dispatch(xt, slots, capacity: int, num_experts: int):
    """The expert buffers [E, Cap, C]: each kept choice's token row of ``xt``
    [T, C] at its slot, zero rows where no token landed. A gather from a
    slot -> token map; the dropped choices write that map one row past the
    buffers, which is cut off (no mask is read on the host)."""
    t, c = xt.shape
    rows = torch.arange(t, device=xt.device)
    full = num_experts * capacity
    source = torch.full((full + 1,), t, dtype=torch.int64, device=xt.device)
    for slot in slots:
        source.scatter_(0, torch.where(slot >= 0, slot, full), rows)
    xpad = torch.cat([xt, xt.new_zeros(1, c)])
    return xpad.index_select(0, source[:-1]).reshape(num_experts, capacity, c)


def combine(out, slots, gates):
    """[T, C]: each token's kept rows of the expert outputs ``out`` [E * Cap,
    C] times their gates, summed (a dropped choice has gate 0)."""
    y = None
    for slot, g in zip(slots, gates):
        term = out.index_select(0, slot.clamp(min=0)) * g[:, None]
        y = term if y is None else y + term
    return y


def _bmm_f32(x, y):
    """x @ y (batched) with an f32 result: compute-dtype operands on a card
    through cuBLAS with an f32 output, elsewhere products of f32 copies
    (exact: a product of two bf16 values is exact in f32)."""
    if x.is_cuda and x.dtype == y.dtype and x.dtype in (torch.bfloat16,
                                                         torch.float16):
        return torch.bmm(x, y, out_dtype=torch.float32)
    return torch.bmm(x.float(), y.float())


def _f32_parts(grad, dtype):
    """The f32 output gradient as operands for products with ``dtype``
    ones, kept in f32 as JAX's transpose keeps it: off a card ``grad``
    itself (the products run on f32 copies); on a card beside bf16
    operands its bf16 rounding and the bf16 rounding of the rest, whose two
    products summed part from the f32 product by about 2^-17 of the terms,
    the size of the f32 sum's own rounding at these lengths, at twice a
    bf16 product's cost (f32 ones take about ten times longer)."""
    if not (grad.is_cuda and dtype == torch.bfloat16):
        return (grad,)
    hi = grad.to(dtype)
    lo = torch.empty_like(hi)
    torch.sub(grad, hi, out=lo)
    return hi, lo


def _summed(products):
    out = next(products)
    for p in products:
        out += p
    return out


class _ExpertProduct(torch.autograd.Function):
    """``_bmm_f32`` of compute-dtype operands; its backward takes the f32
    output gradient unrounded (``_f32_parts``) and returns gradients in the
    operands' dtype, as the JAX einsums' transpose does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        parts = _f32_parts(grad, a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _summed(_bmm_f32(p, b.transpose(1, 2))
                         for p in parts).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _summed(_bmm_f32(a.transpose(1, 2), p)
                         for p in parts).to(b.dtype)
        return ga, gb


class MoEFeedForward(nn.Module):
    """Drop-in MoE replacement for the ViT ``FeedForward`` ([B, N, C] ->
    [B, N, C] in the input's dtype). Parameters in the JAX package's
    layouts: ``router`` [C, E] f32, ``wi`` [E, C, H], ``bi`` [E, 1, H],
    ``wo`` [E, H, C], ``bo`` [E, 1, C]. After a forward, ``aux_loss`` holds
    its load-balance loss plus ``router_z_weight`` times the z-loss, and
    ``dropped`` the share of token choices dropped past capacity."""

    def __init__(self, dim: int, hidden: int, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 router_z_weight: float = 1e-3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        assert top_k <= num_experts, (top_k, num_experts)
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.router_z_weight = router_z_weight
        self.dtype = dtype
        e = num_experts
        self.router = nn.Parameter(torch.empty(dim, e))
        self.wi = nn.Parameter(torch.empty(e, dim, hidden))
        self.bi = nn.Parameter(torch.empty(e, 1, hidden))
        self.wo = nn.Parameter(torch.empty(e, hidden, dim))
        self.bo = nn.Parameter(torch.empty(e, 1, dim))
        self.aux_loss = None
        self.dropped = None

    def reset_parameters(self, generator):
        truncated_normal_(self.router, 0.02, generator)
        _lecun_normal(self.wi, self.wi.shape[1], generator)
        _lecun_normal(self.wo, self.wo.shape[1], generator)
        nn.init.zeros_(self.bi)
        nn.init.zeros_(self.bo)

    def capacity(self, tokens: int) -> int:
        return max(1, int(math.ceil(self.top_k * tokens / self.num_experts)
                          * self.capacity_factor))

    def route(self, xt):
        """(router logits, slots, gates, aux) of the tokens ``xt`` [T, C]."""
        logits = xt.float() @ self.router
        probs = torch.softmax(logits, dim=-1)
        slots, gates, aux = top_k_route(probs, self.capacity(xt.shape[0]),
                                        self.top_k)
        if self.router_z_weight > 0.0:
            z = torch.logsumexp(logits, dim=-1).square().mean()
            aux = aux + self.router_z_weight * z
        return logits, slots, gates, aux

    def forward(self, x, generator=None):
        b, n, c = x.shape
        t, e = b * n, self.num_experts
        xt = x.reshape(t, c)
        if world_size() > 1:
            return self._forward_global(xt, b, n, x.dtype)
        cap = self.capacity(t)
        _, slots, gates, aux = self.route(xt)
        self.aux_loss = aux
        with torch.no_grad():
            self.dropped = sum((s < 0).sum() for s in slots).float() / (
                t * self.top_k)

        cd = self.dtype
        expert_in = dispatch(xt.to(cd), slots, cap, e)
        h = _ExpertProduct.apply(expert_in, self.wi.to(cd)) + self.bi
        h = F.gelu(h, approximate="none")
        out = _ExpertProduct.apply(h.to(cd), self.wo.to(cd)) + self.bo
        y = combine(out.reshape(e * cap, c), slots, gates)
        return y.reshape(b, n, c).to(x.dtype)


    def _expert_ffn(self, rows, j: int):
        """Expert ``j`` of this rank's stacks on ``rows`` [R, C]: f32 [R, C]."""
        cd = self.dtype
        h = _ExpertProduct.apply(rows.to(cd)[None],
                                 self.wi[j:j + 1].to(cd)) + self.bi[j:j + 1]
        h = F.gelu(h, approximate="none")
        return (_ExpertProduct.apply(h.to(cd), self.wo[j:j + 1].to(cd))
                + self.bo[j:j + 1])[0]

    def _forward_global(self, xt, b, n, dtype):
        t, c = xt.shape
        e, cd = self.num_experts, self.dtype
        tokens = t * world_size()
        cap = self.capacity(tokens)
        logits = xt.float() @ self.router
        probs = torch.softmax(logits, dim=-1)
        slots, gates, aux = _global_route(logits, probs, cap, self.top_k,
                                          self.router_z_weight, tokens)
        self.aux_loss = aux
        with torch.no_grad():
            self.dropped = global_sum(sum((s < 0).sum() for s in slots)
                                      .float()) / (tokens * self.top_k)
        group = getattr(self, "expert_group", None)
        if group is None:
            # every rank holds every expert: its own kept rows through them
            expert_in = dispatch(xt.to(cd), slots, cap, e)
            h = _ExpertProduct.apply(expert_in, self.wi.to(cd)) + self.bi
            h = F.gelu(h, approximate="none")
            out = _ExpertProduct.apply(h.to(cd), self.wo.to(cd)) + self.bo
            y = combine(out.reshape(e * cap, c), slots, gates)
            return y.reshape(b, n, c).to(dtype)
        return self._exchange(xt, slots, gates, cap, group).reshape(
            b, n, c).to(dtype)

    def _exchange(self, xt, slots, gates, cap: int, group):
        """The kept rows to their experts' owners and back (two
        ``all_to_all_single`` with autograd, one of the expert indices and
        one of the counts), each choice's output times its gate summed into
        its token's row."""
        from torch.distributed.nn.functional import all_to_all_single
        t, c = xt.shape
        owners = dist.get_world_size(group)
        per = self.wi.shape[0]                        # experts on each rank
        slot = torch.cat(slots)
        token = torch.arange(t, device=xt.device).repeat(len(slots))
        gate = torch.cat(gates)
        kept = torch.nonzero(slot >= 0)[:, 0]
        expert = slot[kept] // cap
        order = kept[torch.argsort(expert, stable=True)]
        expert = slot[order] // cap
        owner = expert // per
        send_counts = torch.bincount(owner, minlength=owners)
        recv_counts = torch.empty_like(send_counts)
        dist.all_to_all_single(recv_counts, send_counts, group=group)
        send_sizes, recv_sizes = send_counts.tolist(), recv_counts.tolist()
        recv_expert = expert.new_empty(sum(recv_sizes))
        dist.all_to_all_single(recv_expert, expert - owner * per, recv_sizes,
                               send_sizes, group=group)
        rows = all_to_all_single(
            xt.new_empty(sum(recv_sizes), c), xt[token[order]], recv_sizes,
            send_sizes, group=group)
        out = rows.new_zeros(rows.shape[0], c, dtype=torch.float32)
        for j in range(per):
            mine = torch.nonzero(recv_expert == j)[:, 0]
            if mine.numel():
                out = out.index_copy(0, mine,
                                     self._expert_ffn(rows[mine], j))
        back = all_to_all_single(out.new_empty(len(order), c), out,
                                 send_sizes, recv_sizes, group=group)
        return torch.zeros(t, c, device=xt.device).index_add(
            0, token[order], back * gate[order][:, None])


def expert_param_sharding(mesh, model: nn.Module, axis: str = "fsdp"):
    """The expert stacks' sharding (counterpart of the JAX package's):
    ``{name: 0 or None}`` over ``model``'s parameters, 0 (the leading
    ``[E]`` dim split over ``mesh``'s ``axis``) for the ``wi``, ``bi``,
    ``wo`` and ``bo`` of each ``MoEFeedForward`` whose expert count the
    axis divides, None (replicated) for everything else."""
    n_ax = 1 if mesh is None else mesh[axis].size()
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = 0 if (leaf in _EXPERT_LEAVES and n_ax > 1
                          and p.shape[0] % n_ax == 0) else None
    return out


@torch.no_grad()
def shard_experts(model: nn.Module, mesh, axis: str = "fsdp"):
    """Keeps on this rank only its slice of each expert stack that
    ``expert_param_sharding`` shards: the experts ``[i * E / n, (i + 1) *
    E / n)`` for rank ``i`` of ``n`` along ``axis``. Each such layer sends
    its rows to the experts' owners (``expert_group``), and the engine
    averages the slices' gradients over the ranks that hold the same
    experts (the other mesh dim). Call it before the optimizer is built."""
    plan = expert_param_sharding(mesh, model, axis)
    if not any(d is not None for d in plan.values()):
        return model
    others = [d for d in mesh.mesh_dim_names if d != axis]
    replicas = mesh[others[0]].get_group() if others else None
    n, i = mesh[axis].size(), mesh[axis].get_local_rank()
    names = {id(p): name for name, p in model.named_parameters()}
    for m in model.modules():
        if not isinstance(m, MoEFeedForward) or plan[names[id(m.wi)]] is None:
            continue
        per = m.num_experts // n
        for leaf in _EXPERT_LEAVES:
            part = nn.Parameter(getattr(m, leaf)[i * per:(i + 1) * per]
                                .clone())
            part._sync_group = replicas
            setattr(m, leaf, part)
        m.expert_group = mesh[axis].get_group()
    return model


def moe_aux_loss(model: nn.Module):
    """The sum of the auxiliary losses of ``model``'s MoE layers from their
    last forward; None for a model without any (or before a forward)."""
    total = None
    for m in model.modules():
        if isinstance(m, MoEFeedForward) and m.aux_loss is not None:
            total = m.aux_loss if total is None else total + m.aux_loss
    return total
