"""Ring attention: exact attention over sequence shards (counterpart of
``simpleaicv_tpu/parallel/ring_attention.py``).

Each rank of a ring of S holds the [B, H, N / S, D] shard of q, k and v of
a sequence of N tokens. Q stays put; the K/V shards travel around the ring
(``batch_isend_irecv``: each hop sends to rank + 1 and receives from
rank - 1, S - 1 hops), and each hop folds one [N/S x N/S] score block into
an f32 online softmax (running max ``m``, denominator ``l``, unnormalised
output ``o``), as the JAX function does, with its per-hop block in f32
products. The result is exact attention over the whole sequence, and no
rank holds more than its own K/V shard and the one in flight.

The backward is the reverse of the JAX package's transpose of ``ppermute``
written out: each rank recomputes its score blocks from its q, the log-sum-
exp of the forward and each visiting K/V shard; dQ stays local, while the
dK/dV of a shard travel with it and arrive home after S hops.

``ring_attention_local`` works on this rank's shards inside a process
group; ``make_ring_attention`` binds it to a mesh dim.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_attention_local", "make_ring_attention"]


def _rotate(t, group):
    """``t`` sent to the next rank of ``group``'s ring, the previous rank's
    returned."""
    s = dist.get_world_size(group)
    if s == 1:
        return t
    r = dist.get_rank(group)
    nxt, prv = (r + 1) % s, (r - 1) % s
    if group is not None:
        nxt = dist.get_global_rank(group, nxt)
        prv = dist.get_global_rank(group, prv)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, nxt, group),
           dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        s = dist.get_world_size(group)
        qf = q.float() * scale
        kv = torch.stack([k, v])
        o = m = l = None
        for hop in range(s):
            if hop:
                kv = _rotate(kv, group)
            scores = torch.einsum("bhnd,bhmd->bhnm", qf, kv[0].float())
            if m is None:
                m = scores.amax(dim=-1, keepdim=True)
                p = torch.exp(scores - m)
                l = p.sum(dim=-1, keepdim=True)
                o = torch.einsum("bhnm,bhmd->bhnd", p, kv[1].float())
                continue
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            p = torch.exp(scores - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.einsum("bhnm,bhmd->bhnd", p,
                                         kv[1].float())
            m = m_new
        out = o / l
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        s = dist.get_world_size(group)
        qf = q.float() * scale
        do = dout.float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
        for hop in range(s):
            kf, vf = kv[0].float(), kv[1].float()
            p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qf, kf) - lse)
            ds = p * (torch.einsum("bhnd,bhmd->bhnm", do, vf) - delta)
            dq += torch.einsum("bhnm,bhmd->bhnd", ds, kf)
            dkv[0] += torch.einsum("bhnm,bhnd->bhmd", ds, qf)
            dkv[1] += torch.einsum("bhnm,bhnd->bhmd", p, do)
            # the shard moves on with its gradient; after S hops both are
            # home
            if hop < s - 1:
                kv = _rotate(kv, group)
            dkv = _rotate(dkv, group)
        return ((dq * scale).to(q.dtype), dkv[0].to(k.dtype),
                dkv[1].to(v.dtype), None, None)


def ring_attention_local(q, k, v, group=None, scale: float | None = None):
    """Exact softmax attention over ring-sharded K/V.

    q, k, v: [B, H, N_local, D], this rank's shard of the sequence, the
    ranks of ``group`` (default: the world) holding consecutive shards in
    rank order. Returns [B, H, N_local, D] in q's dtype: this rank's rows of
    the attention over the whole sequence. Differentiable."""
    scale = q.shape[-1]**-0.5 if scale is None else scale
    if not dist.is_initialized():
        scores = torch.einsum("bhnd,bhmd->bhnm", q.float() * scale,
                              k.float())
        return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(scores, -1),
                            v.float()).to(q.dtype)
    return _RingAttention.apply(q, k, v, group, scale)


def make_ring_attention(mesh, axis: str = "sp", data_axis: str | None = None,
                        scale: float | None = None):
    """``fn(q, k, v) -> out`` on this rank's [B_local, H, N_local, D]
    shards, the sequence sharded over ``mesh``'s dim ``axis`` (the world
    when ``mesh`` is None) and, with ``data_axis``, the batch over that dim
    (each data slice runs its own ring)."""
    del data_axis  # the batch slice is the caller's; each ring is one dim
    group = None if mesh is None else mesh[axis].get_group()

    def fn(q, k, v):
        return ring_attention_local(q, k, v, group=group, scale=scale)

    return fn
