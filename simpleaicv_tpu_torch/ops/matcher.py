"""Bipartite matching by the auction algorithm (Bertsekas), on the device
(counterpart of ``simpleaicv_tpu/ops/matcher.py``).

``auction_match_batch(cost, valid_m)`` assigns every valid ground truth of
each image one query by a synchronous (Jacobi) forward auction from zero
prices with one small ``eps``; the result is within ``n_gt * eps`` of the
optimal total cost. It is plain PyTorch on the cost's device: no host
matcher and no copy of the costs.

The JAX function runs its loop as a ``lax.while_loop`` under ``vmap``. Here
the loop runs over the whole batch at once, in chunks of ``CHUNK``
iterations between host checks of whether any bidder is left (one sync a
chunk, not one an iteration). That is exact: an iteration with no bidder
changes nothing, and an image that has finished stays as it is while the
others go on. The loop never runs past ``max_iters``, because the cap
decides which ground truths stay unmatched where near-duplicate ground
truths contend for one query. The ties are the JAX function's: the first
maximum in every ``argmax``, ``eps`` from the f32 span of the values, and
scatters that drop out-of-range indices.
"""

from __future__ import annotations

import torch

__all__ = ["auction_match", "auction_match_batch", "CHUNK"]

_NEG = -1e30
# auction iterations between two host checks of whether any bidder is left
CHUNK = 16


def _values(cost, valid_m):
    """v [B, M, Q]: person (gt) i's value of object (query) j, ``_NEG``
    for an invalid gt; non-finite costs count as 1e8."""
    cost = cost.float()
    cost = torch.where(torch.isfinite(cost), cost,
                       torch.full_like(cost, 1e8))
    v = -cost.transpose(1, 2)
    return torch.where(valid_m[:, :, None], v, torch.full_like(v, _NEG))


def _eps(v, valid_m, eps):
    """[B, 1] bid increment: ``eps``, or 1e-4 of the span of the valid
    values, at least 1e-3 (the JAX function's f32 arithmetic)."""
    if eps is not None:
        return torch.full((v.shape[0], 1), float(eps), dtype=torch.float32,
                          device=v.device)
    span = torch.where(valid_m[:, :, None], v.abs(),
                       torch.zeros_like(v)).amax(dim=(1, 2))
    span = torch.clamp(span, min=1.0)
    return torch.clamp(span * 1e-4, min=1e-3)[:, None]


def _step(v, valid_m, eps_val, assign_i, owner_j, prices):
    """One auction iteration on every image; returns the new
    (assign_i [B, M], owner_j [B, Q], prices [B, Q])."""
    b, m, q = v.shape
    bidder = valid_m & (assign_i < 0)                          # [B, M]
    net = v - prices[:, None, :]                               # [B, M, Q]
    best_val, best_j = net.max(dim=2)
    one_hot_best = torch.zeros_like(net, dtype=torch.bool)
    one_hot_best.scatter_(2, best_j[..., None], True)
    second_val = torch.where(one_hot_best, torch.full_like(net, _NEG),
                             net).amax(dim=2)
    bid = prices.gather(1, best_j) + (best_val - second_val) + eps_val
    # each bidder bids on exactly one object, so the winners are distinct
    bid_mat = torch.where(one_hot_best & bidder[:, :, None], bid[:, :, None],
                          torch.full_like(net, _NEG))          # [B, M, Q]
    win_bid, win_i = bid_mat.max(dim=1)                        # [B, Q]
    got = win_bid > _NEG / 2
    prices = torch.where(got, win_bid, prices)
    # the previous owners of re-auctioned objects lose their assignment;
    # index m is the dropped slot
    lost_gt = torch.where(got & (owner_j >= 0), owner_j,
                          torch.full_like(owner_j, m))
    padded = torch.cat([assign_i, assign_i.new_full((b, 1), -1)], dim=1)
    padded.scatter_(1, lost_gt, -1)
    owner_j = torch.where(got, win_i, owner_j)
    obj_ids = torch.arange(q, device=v.device).expand(b, q)
    new_q = torch.where(got, obj_ids, torch.full_like(obj_ids, -1))
    padded.scatter_(1, torch.where(got, win_i, torch.full_like(win_i, m)),
                    new_q)
    return padded[:, :m], owner_j, prices


@torch.no_grad()
def auction_match_batch(cost, valid_m, *, eps: float | None = None,
                        max_iters: int = 2000):
    """cost [B, Q, M] (min-cost), valid_m [B, M] bool -> the matched gt
    index of every query [B, Q] int64, -1 for unmatched queries, on
    cost's device."""
    cost = cost.detach()
    b, q, m = cost.shape
    valid_m = valid_m.to(device=cost.device, dtype=torch.bool)
    if m == 0:
        return torch.full((b, q), -1, dtype=torch.long, device=cost.device)
    v = _values(cost, valid_m)
    eps_val = _eps(v, valid_m, eps)
    assign_i = torch.full((b, m), -1, dtype=torch.long, device=cost.device)
    owner_j = torch.full((b, q), -1, dtype=torch.long, device=cost.device)
    prices = torch.zeros((b, q), dtype=torch.float32, device=cost.device)
    it = 0
    while it < max_iters and bool((valid_m & (assign_i < 0)).any()):
        for _ in range(min(CHUNK, max_iters - it)):
            assign_i, owner_j, prices = _step(v, valid_m, eps_val, assign_i,
                                              owner_j, prices)
        it += min(CHUNK, max_iters - it)
    # where max_iters cut the auction, drop the gts still unassigned from
    # owner_j too
    orphaned = assign_i < 0
    owner_valid = (owner_j >= 0) & ~orphaned.gather(
        1, owner_j.clamp(0, m - 1))
    return torch.where(owner_valid, owner_j, torch.full_like(owner_j, -1))


def auction_match(cost, valid_m, **kwargs):
    """cost [Q, M], valid_m [M] -> [Q] matched gt index (-1)."""
    return auction_match_batch(cost[None], valid_m[None], **kwargs)[0]
