"""Sharded BFS: vertex-sharded BSP supersteps over the shard mesh, with
direction optimization.

Counterpart of :mod:`gunrock_tpu.parallel.bfs` (the reference's
multi-GPU BFS, ``gunrock/app/bfs/bfs_enactor.cuh`` and the
``enactor_loop.cuh`` stage machine). Each superstep is either

  push:  every shard's advance -> bucket by owner -> all-to-all -> merge
  pull:  gather the frontier bitmask (V/32 words) -> each shard's CSC

The JAX package runs the traversal as one ``lax.while_loop`` under
``shard_map``; here it is a host loop with the same condition
(``n_global > 0``, ``it < max_iters``, no overflow), reading the global
scalars once a superstep, as the port's single-card loops do. The
shards' arrays are stacked on one device (``parallel/mesh.py``), so a
push step expands every shard's frontier in one pass and routes the
lanes with ``comm.route_by_owner``: a receiver reads its lanes sender by
sender, each sender's in lane order, the order of the JAX package's
all-to-all, so ``dedup_winners`` keeps the same winner and the
predecessors agree. A lane past a capacity (``out_cap`` a shard, the
per-peer buffer, ``fcap`` a frontier) is dropped and flags the overflow,
as the JAX package's fixed buffers drop it, and :func:`bfs_sharded`
retries with doubled sizing.

The direction vote is the JAX package's on float32 global scalars
(``m_f`` summed over shards as int32, then float32;
``unexplored`` a float32 running difference), computed on the host in
numpy float32, so ``direction_trace`` is equal. With ``blocked`` (shard
views, ``parallel/blocked.py``) a pull superstep runs kernel K1 once a
shard over the gathered global frontier words; without, one segmented
reduction over every shard's CSC. Pull-discovered predecessors are the
first in-edge whose source is in the frontier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import sync
from ..ops import kernels as K
from ..ops.segment import dedup_winners
from ..utils.info import make_info
from ..utils.track import inject_latency
from .blocked import ShardedBlocked, blocked_from_partition
from .comm import ShardAdvance, first_per_shard, route_by_owner
from .mesh import Mesh, info_graph, make_mesh, mesh_of
from .partition import PartitionedGraph, flat_rows, partition

__all__ = ["bfs_sharded", "bfs_sharded_device", "ShardedBfsResult"]

DIR_TRACE = 512  # per-iteration direction record (1 = pull)


@dataclasses.dataclass
class ShardedBfsResult:
    labels: np.ndarray
    preds: Optional[np.ndarray]
    info: dict


class _Bfs:
    """One traversal's graph-side tensors and its push and pull steps."""

    def __init__(self, pg: PartitionedGraph, *, fcap, out_cap,
                 per_peer_cap, mark_preds, direction_optimized,
                 comm_latency, blocked):
        self.p, self.S = pg.num_shards, pg.shard_size
        self.V = self.p * self.S
        self.fcap, self.out_cap, self.per_peer_cap = fcap, out_cap, \
            per_peer_cap
        self.mark_preds, self.comm_latency = mark_preds, comm_latency
        self.blocked = blocked
        self.adv = ShardAdvance(pg)
        self.deg = self.adv.deg                                  # (V,)
        if direction_optimized:
            self.csc = flat_rows(pg.csc_offsets, pg.csc_indices)
            self.csc_edges = pg.csc_offsets[:, -1].tolist()

    def shard_counts(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.bincount(ids.long() // self.S, minlength=self.p)

    def push(self, labels, preds, frontier, depth):
        """Advance every shard's frontier (global ids, grouped by shard),
        route by owner, merge. Returns ``(frontier, n, m_f, e_it,
        overflow, sent)``; n, m_f, e_it and sent a list a shard."""
        p, S = self.p, self.S
        src, dst, _, sender, tot_l = self.adv.expand(frontier)
        overflow = max(tot_l, default=0) > self.out_cap
        if overflow:
            keep = first_per_shard(sender, p, self.out_cap)
            src, dst, sender = src[keep], dst[keep], sender[keep]
        owner = dst // S
        counts, kept = route_by_owner(sender, owner, p, self.per_peer_cap)
        if kept is not None:
            overflow = True
            src, dst, owner = src[kept], dst[kept], owner[kept]
        sent = (counts.clamp(max=self.per_peer_cap).sum(dim=1)
                * (8 if self.mark_preds else 4)).tolist()
        for payload in (dst, src) if self.mark_preds else (dst,):
            inject_latency(payload, self.comm_latency)
        # Expand_Incoming: a lane's receive order is its order here
        # (sender, then lane), so the highest lane wins as in the JAX
        # package; the new frontier is each receiver's winners in that
        # order.
        keep = dedup_winners(dst, labels[dst] == -1, self.V)
        win = dst[keep]
        labels[win] = depth
        if preds is not None:
            preds[win] = src[keep]
        order = torch.sort(owner[keep], stable=True).indices
        new = win[order].to(torch.int32)
        n = self.shard_counts(new)
        m_f = torch.zeros(p, dtype=torch.int64, device=new.device)
        m_f.index_add_(0, win // S, self.deg[win])
        n_l, m_f_l = torch.stack([n, m_f]).tolist()
        if max(n_l) > self.fcap:
            overflow = True
            new = new[first_per_shard(new.long() // S, p, self.fcap)]
        return new, n_l, m_f_l, tot_l, overflow, sent

    def pull(self, labels, preds, depth):
        """Gather the frontier words, reach every shard's rows (K1 a
        shard with ``blocked``), label the new vertices. Returns ``(n,
        m_f, e_it, sent)``, a list a shard."""
        p, S = self.p, self.S
        words = inject_latency(K.pack_bitmask(labels == depth - 1),
                               self.comm_latency)
        if self.blocked is not None:
            reached = torch.cat([K.unpack_bitmask(
                K.pull_reached_words(words, view), S)
                for view in self.blocked.views])
        else:
            hit = K.unpack_bitmask(words, self.V)[self.csc.ids]
            counts = torch.segment_reduce(hit.to(torch.float32), "sum",
                                          offsets=self.csc.offsets)
            reached = counts > 0
        new = (labels == -1) & reached
        labels[new] = depth
        if preds is not None:
            preds[new] = self._first_hit_parent(words)[new]
        n = new.view(p, S).sum(dim=1)
        m_f = torch.where(new, self.deg, 0).view(p, S).sum(dim=1)
        n_l, m_f_l = torch.stack([n, m_f]).tolist()
        sent = [(p - 1) * (S // 32) * 4] * p
        return n_l, m_f_l, self.csc_edges, sent

    def _first_hit_parent(self, words) -> torch.Tensor:
        """(V,) int32: each row's first in-edge source in the frontier
        (garbage where the row has none, which the caller masks off)."""
        ids = self.csc.ids
        hit = K.unpack_bitmask(words, self.V)[ids]
        pos = torch.where(hit, torch.arange(ids.shape[0], device=ids.device,
                                            dtype=torch.float64),
                          float("inf"))
        first = torch.segment_reduce(pos, "min", offsets=self.csc.offsets)
        first = torch.where(torch.isfinite(first), first, 0).long()
        if ids.shape[0] == 0:
            return torch.zeros(self.V, dtype=torch.int32, device=ids.device)
        return ids[first.clamp(max=ids.shape[0] - 1)].to(torch.int32)


def bfs_sharded_device(pg: PartitionedGraph, src_new: int, *,
                       mesh: Optional[Mesh] = None,
                       mark_preds: bool = False,
                       direction_optimized: bool = False,
                       alpha: float = 15.0, beta: float = 18.0,
                       comm_latency: int = 0,
                       queue_sizing: float = 1.0,
                       in_sizing: float = 1.0,
                       max_iters: Optional[int] = None,
                       blocked: Optional[ShardedBlocked] = None):
    """Run sharded BFS in relabeled id space; returns ``(labels, preds,
    iters, edges, overflow, comm_bytes, direction_trace)``, as the JAX
    function does: labels (and preds, or None without ``mark_preds``)
    over the p*S relabeled vertices as tensors on the partition's
    device, the superstep count, the largest shard's float32 edge count,
    the overflow flag, the float32 byte count and the (512,) int32
    direction record.

    ``blocked``: the global shard views (``blocked_from_partition(pg)``);
    pull supersteps then run kernel K1 once a shard."""
    mesh_of(pg, mesh)
    if direction_optimized and pg.csc_offsets is None:
        raise ValueError(
            "direction-optimized sharded BFS needs partition(with_csc=True)")
    p, S = pg.num_shards, pg.shard_size
    fcap = max(128, int(S * min(queue_sizing, 1.0)))
    out_cap = max(128, int(pg.e_shard_pad * min(queue_sizing, 1.0)))
    per_peer_cap = max(128, int(out_cap * min(in_sizing, 1.0)))
    if max_iters is None:
        max_iters = pg.num_nodes + 1
    run = _Bfs(pg, fcap=fcap, out_cap=out_cap, per_peer_cap=per_peer_cap,
               mark_preds=mark_preds, direction_optimized=direction_optimized,
               comm_latency=comm_latency, blocked=blocked)
    dev = pg.device
    src_new = int(src_new)
    labels = torch.full((p * S,), -1, dtype=torch.int32, device=dev)
    labels[src_new] = 0
    preds = torch.full_like(labels, -1) if mark_preds else None
    frontier = torch.tensor([src_new], dtype=torch.int32, device=dev)
    m_f = int(run.deg[src_new])
    f32 = np.float32
    it, ovf, use_pull, fvalid, n_global = 0, False, False, True, 1
    unexplored, comm_bytes = f32(pg.num_edges), f32(0)
    edges = np.zeros(p, np.float32)
    trace = np.full(DIR_TRACE, -1, np.int32)
    while n_global > 0 and it < max_iters and not ovf:
        depth = it + 1
        m_f_global = f32(m_f)
        pick_pull = False
        if direction_optimized:
            # The Beamer vote on global scalars: identical on every
            # shard in the JAX package, so no consensus step.
            to_pull = m_f_global * f32(alpha) > unexplored
            to_push = f32(n_global) * f32(beta) < f32(pg.num_nodes)
            pick_pull = bool(not to_push if use_pull else to_pull)
        if pick_pull:
            n, m_f_s, e_it, sent = run.pull(labels, preds, depth)
            step_ovf = False
        else:
            rebuild_ovf = False
            if not fvalid:
                # lazy queue rebuild after pull supersteps
                frontier = torch.nonzero(labels == depth - 1).flatten() \
                    .to(torch.int32)
                if max(run.shard_counts(frontier).tolist()) > fcap:
                    rebuild_ovf = True
                    frontier = frontier[first_per_shard(
                        frontier.long() // S, p, fcap)]
            frontier, n, m_f_s, e_it, step_ovf, sent = run.push(
                labels, preds, frontier, depth)
            step_ovf |= rebuild_ovf
        fvalid = not pick_pull
        n_global = sum(n)
        ovf = ovf or step_ovf
        comm_bytes = f32(comm_bytes + f32(sum(sent)))
        trace[min(it, DIR_TRACE - 1)] = int(pick_pull)
        edges = (edges + np.asarray(e_it, np.float32)).astype(np.float32)
        unexplored = f32(unexplored - m_f_global)
        use_pull = pick_pull
        m_f = sum(m_f_s)
        it += 1
    return labels, preds, it, float(edges.max()), ovf, comm_bytes, trace


def bfs_sharded(graph: CsrGraph, src: int = 0, *, num_shards: int = None,
                partition_method: str = "random", seed: int = 0,
                mark_preds: bool = False,
                direction_optimized: bool = False,
                alpha: float = 15.0, beta: float = 18.0,
                comm_latency: int = 0,
                mesh: Optional[Mesh] = None,
                queue_sizing: float = 1.0, in_sizing: float = 1.0,
                max_iters: Optional[int] = None,
                use_blocked: Optional[bool] = None,
                device="cuda") -> ShardedBfsResult:
    """Partition ``graph`` onto the mesh (``mesh``, or ``num_shards``
    shards on ``device``) and run BFS; returns results in original vertex
    ids (the reference's Extract stitches sub-GPU results via
    ``original_vertex`` tables, ``bfs_problem.cuh:518``).

    ``use_blocked`` routes pull supersteps through kernel K1 once a shard
    (default: on a CUDA mesh when direction-optimized); on the CPU it
    runs the same shard views through K1's plain version."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards, device=device)
    num_shards = mesh.num_shards
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if use_blocked is None:
        use_blocked = direction_optimized and mesh.device.type == "cuda"

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=direction_optimized,
                             device=mesh.device)
        blocked = blocked_from_partition(pg) if use_blocked else None
        sync(mesh.device)
    with timer.time("process_ms"):
        # Overflow retry with doubled sizing (reference Check_Size
        # regrow, enactor_helper.cuh:103-138): sizing 1.0 cannot
        # overflow, so this ends with complete results.
        qs, ins = queue_sizing, in_sizing
        while True:
            labels, preds, iters, edges, ovf, comm_bytes, trace = \
                bfs_sharded_device(
                    pg, int(perm[src]), mesh=mesh, mark_preds=mark_preds,
                    direction_optimized=direction_optimized, alpha=alpha,
                    beta=beta, comm_latency=comm_latency, queue_sizing=qs,
                    in_sizing=ins, max_iters=max_iters, blocked=blocked)
            if not ovf or (qs >= 1.0 and ins >= 1.0):
                break
            qs = min(qs * 2.0, 1.0)
            ins = min(ins * 2.0, 1.0)
        labels_new = labels.cpu().numpy()
        preds_new = preds.cpu().numpy() if mark_preds else None

    labels_old = labels_new[perm]
    preds_old = None
    if mark_preds:
        inv = np.full(pg.v_global_pad, -1, np.int64)
        inv[perm] = np.arange(graph.num_nodes)
        pn = preds_new[perm]
        preds_old = np.where(pn >= 0, inv[np.maximum(pn, 0)],
                             -1).astype(np.int32)
    degs = np.diff(graph.row_offsets).astype(np.int64)
    info = make_info(
        primitive="bfs_sharded", graph=info_graph(graph, mesh), timer=timer,
        edges_visited=int(degs[labels_old >= 0].sum()),
        extra={"src": int(src), "num_shards": int(num_shards),
               "partition_method": partition_method,
               "num_iterations": iters,
               "frontier_overflow": bool(ovf),
               "direction_optimized": direction_optimized,
               "blocked_kernels": bool(use_blocked),
               "direction_trace": trace[:min(iters, DIR_TRACE)].tolist(),
               "pull_iterations": int((trace[:iters] == 1).sum()),
               "comm_bytes": float(comm_bytes),
               "comm_latency_rounds": comm_latency,
               "search_depth": int(labels_old.max(initial=0))},
    )
    return ShardedBfsResult(labels=labels_old, preds=preds_old, info=info)
