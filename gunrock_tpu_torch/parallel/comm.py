"""Boundary exchange over the shard mesh: bucket by owner, all-to-all,
ghost exchange.

Counterpart of :mod:`gunrock_tpu.parallel.comm` (the reference's
``enactor_helper.cuh`` PushNeighbor and ``enactor_kernel.cuh:343``
Make_Output_Kernel). Every shard lies on one device
(``parallel/mesh.py``), so the collectives are tensor operations over
the leading shard axis of stacked tensors, and take no axis name:

  * ``jax.lax.all_to_all(x, tiled=True)`` of each shard's ``(p, B)``
    buffer is ``x.transpose(0, 1)`` of the stacked ``(p, p, B)`` tensor;
  * ``all_gather`` is a reshape of the stacked tensor;
  * ``psum``, ``pmin`` and ``pmax`` are reductions over dim 0.

:func:`bucket_by_owner` works on one shard's lanes, as the JAX function
does inside ``shard_map``; stack its outputs to exchange them. The
primitives' push steps (``parallel/bfs.py``, ``parallel/sssp.py``) route
every shard's lanes at once with :func:`route_by_owner`, which gives the
same receive order without the ``(p, p, B)`` buffers.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.track import inject_latency

__all__ = ["bucket_by_owner", "exchange", "recv_mask", "ghost_exchange",
           "route_by_owner", "first_per_shard", "ShardAdvance"]


def ghost_exchange(values: torch.Tensor, send_idx: torch.Tensor, *,
                   comm_latency: int = 0) -> torch.Tensor:
    """Boundary-only value exchange: stacked ``(p, S)`` values -> the
    ``(p, S + p*ghost_cap)`` compact value tables that ``csc_local`` (or
    ``col_local``) address.

    ``send_idx[i]`` is shard i's ``(p, ghost_cap)`` producer table (row j
    = the local ids of i's vertices that shard j reads); shard j's table
    is its own values, then what each shard i sent it, in order of i
    (reference PushNeighbor associates, ``enactor_helper.cuh:297-405``)."""
    p = values.shape[0]
    rows = torch.arange(p, device=values.device)[:, None, None]
    send = values[rows, send_idx.long()]               # (p, p, G)
    recv = inject_latency(send.transpose(0, 1), comm_latency)
    return torch.cat([values, recv.reshape(p, -1)], dim=1)


def bucket_by_owner(owner: torch.Tensor, mask: torch.Tensor,
                    payloads: Sequence[torch.Tensor], *, num_shards: int,
                    per_peer_cap: int):
    """Pack one shard's masked lanes into dense per-peer buffers.

    Returns ``(bufs, counts, overflow)``: each ``bufs[k]`` has shape
    ``(num_shards, per_peer_cap)``, ``counts`` is ``(num_shards,)``
    int32, and lanes past a peer's cap are dropped with ``overflow``
    True. A stable sort by owner keeps each peer's lanes in lane order
    (the order decides which push winner ``dedup_winners`` keeps), and
    dropped lanes go to one slot past the buffers, as in the JAX
    package."""
    cap = owner.shape[0]
    p = num_shards
    dev = owner.device
    key = torch.where(mask, owner.long(), p)
    skey, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        skey, torch.arange(p + 1, device=dev)).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    lane = torch.arange(cap, device=dev)
    pos = lane - starts[skey.clamp(max=p - 1)]
    valid = (skey < p) & (pos < per_peer_cap)
    flat = torch.where(valid, skey * per_peer_cap + pos, p * per_peer_cap)
    bufs = []
    for payload in payloads:
        buf = torch.zeros(p * per_peer_cap + 1, dtype=payload.dtype,
                          device=dev)
        buf[flat] = payload[order]
        bufs.append(buf[:-1].view(p, per_peer_cap))
    overflow = bool((counts > per_peer_cap).any())
    return bufs, counts.clamp(max=per_peer_cap), overflow


def exchange(bufs: Sequence[torch.Tensor], counts: torch.Tensor):
    """All-to-all of every shard's per-peer buffers: ``bufs[k]`` is the
    stacked ``(p, p, B)`` send tensor (``[i, j]`` what shard i sends to
    j), ``counts`` ``(p, p)``. Returns ``(recv_bufs, recv_counts)``, with
    ``[j, i]`` what shard j received from shard i."""
    return ([b.transpose(0, 1) for b in bufs], counts.transpose(0, 1))


def recv_mask(recv_counts: torch.Tensor, per_peer_cap: int) -> torch.Tensor:
    """``(..., p, B)`` validity mask of received buffers."""
    lane = torch.arange(per_peer_cap, device=recv_counts.device)
    return lane < recv_counts[..., None]


def route_by_owner(sender: torch.Tensor, owner: torch.Tensor,
                   num_shards: int, per_peer_cap: int):
    """Route every shard's lanes at once: ``sender`` and ``owner`` give
    each lane's shards, the lanes concatenated in sender order (each
    shard's in its own lane order). Returns ``(counts, kept)``: the
    ``(p, p)`` int64 lane counts of each (sender, owner) pair before the
    cap, and the bool mask of the lanes a ``per_peer_cap`` buffer keeps
    (the first ``per_peer_cap`` of each pair, as :func:`bucket_by_owner`
    keeps them), or None when no pair passes the cap.

    A receiver reads its lanes sender by sender, each sender's in lane
    order: the order of the concatenated lanes restricted to that
    receiver, which a stable sort by owner gives."""
    p = num_shards
    pair = sender.long() * p + owner.long()
    counts = torch.bincount(pair, minlength=p * p).view(p, p)
    if int(counts.max()) <= per_peer_cap if counts.numel() else True:
        return counts, None
    spair, order = torch.sort(pair, stable=True)
    first = torch.searchsorted(spair, spair, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device) - first
    return counts, rank < per_peer_cap


def first_per_shard(shard: torch.Tensor, num_shards: int,
                    cap: int) -> torch.Tensor:
    """Mask of the lanes among the first ``cap`` of their shard, for lanes
    grouped by shard (``shard`` of each): what a buffer of ``cap`` lanes a
    shard keeps."""
    counts = torch.bincount(shard, minlength=num_shards)
    start = torch.cumsum(counts, 0) - counts
    return torch.arange(shard.shape[0], device=shard.device) \
        - start[shard] < cap


class ShardAdvance:
    """Every shard's push advance at once over a partition's stacked CSR
    (``row_offsets`` shard-local, ``col_indices`` global ids): a
    frontier of global ids, grouped by shard in each shard's order,
    expands to one lane an out-edge, in frontier order and then CSR
    order, as each shard's ``_expand_csr`` orders its lanes in the JAX
    package. ``deg`` is every vertex's out-degree, ``(p*S,)``."""

    def __init__(self, pg):
        self.p, self.S = pg.num_shards, pg.shard_size
        row = pg.row_offsets.long()
        e = pg.col_indices.shape[1]
        self.deg = (row[:, 1:] - row[:, :-1]).reshape(-1)
        self.start = (row[:, :-1] + torch.arange(
            self.p, device=row.device)[:, None] * e).reshape(-1)
        self.col = pg.col_indices.reshape(-1)

    def expand(self, frontier: torch.Tensor):
        """``(src, dst, eid, sender, totals)``: each lane's source and
        destination (global ids; int32 and int64), its position in the
        flattened stacked edge arrays, its sender shard, and each shard's
        lane count (a list, read from the device once)."""
        f = frontier.long()
        d = self.deg[f]
        sender_f = f // self.S
        tot = torch.zeros(self.p, dtype=torch.int64, device=f.device)
        tot.index_add_(0, sender_f, d)
        totals = tot.tolist()
        total = sum(totals)
        ends = torch.cumsum(d, 0)
        rank = torch.repeat_interleave(
            torch.arange(f.shape[0], device=f.device), d, output_size=total)
        eid = torch.arange(total, device=f.device) + \
            (self.start[f] - (ends - d))[rank]
        return (frontier[rank], self.col[eid].long(), eid, sender_f[rank],
                totals)
