"""Single-source shortest paths.

Counterpart of :mod:`gunrock_tpu.models.sssp` (reference
``gunrock/app/sssp/``): push rounds relax ``dist[dst] = min(dist[dst],
dist[src] + w)`` (``sssp_functor.cuh:59-99``) with a deterministic winner
per destination, and the improved vertices form the next frontier. Modes:

  * ``bellman``: plain advance + winner rounds.
  * ``nearfar``: the near-far pile of ``priority_queue/near_far_pile.cuh``:
    only vertices below the threshold ``level`` are relaxed; the far pile
    is a vertex mask, and the threshold rises by ``delta`` when the near
    bucket drains (``_bisect``).
  * ``pull``: min-pull sweeps (kernel K6) to the fixpoint, with the JAX
    package's bail-out to ``nearfar`` on high-diameter graphs. A
    ``bellman`` call on a graph with ``has_pull2`` takes this route, as in
    the JAX package (``GUNROCK_SSSP_PULL2``).

Small frontiers run the deep micro-loop (``_deep_stretch``), whose rounds
stay at the rung width ``C`` (``GUNROCK_SSSP_DEEP``,
``GUNROCK_SSSP_DEEP_RUNGS``); ``deep_carry`` (``GUNROCK_SSSP_CARRY``)
carries the queue's distances and degrees through them, and their
payload comes through kernel K5's two-array mode alone. Rounds whose
frontier's edge volume passes
``E / GUNROCK_SSSP_PULL_DIV`` pull over the CSC instead (kernel K3), on
CUDA graphs uploaded ``with_blocked_values`` or past 2^31 edges
(``DeviceGraph.k3_pulls``). ``fused`` resolves winners
with kernels K7 and K8 after one sort (``GUNROCK_SSSP_FUSED``, CUDA).

Routing follows the JAX package's, with "the graph's tensors lie on CUDA"
where it reads "the backend is a TPU"; on the CPU the port takes the JAX
package's CPU routing, which the parity tests compare. Push payloads go
through kernel K5 (``sample_sorted2``, ``sample_sorted``) on CUDA.

The JAX package runs the loop on the device. Here it runs on the host,
as the port's BFS does, and reads a few counts a round; ``dist`` and the
far pile are updated in place. Every relaxation rounds ``dist[u] + w`` as
a float32 add, and every route reaches the same fixpoint, so the
distances of all routes are bitwise equal and :func:`_fill_preds`
recovers parents by exact equality.

The predecessors form a shortest-path tree rooted at the source: each
reached vertex but the source names an in-neighbour ``u`` with
``dist[u] + w == dist[v]`` whose chain of predecessors ends at the
source; the source and the unreached vertices name -1. A weight of 0,
or one below half an ulp of the distance it is added to, makes two
neighbours equally far, each a hit for the other; the fill takes a
strictly nearer in-neighbour first, and settles such ties only on
vertices already in the tree (:func:`_fill_preds`), where the JAX
package's fill can point the two at each other.

Tracing (:mod:`~gunrock_tpu_torch.enactor`): a public call is the root
span ``sssp`` with the splits ``sssp.process``, ``sssp.copy`` and
``sssp.record``; each round of the loop is an ``sssp.round`` span whose
``kind`` is ``push``, ``pull`` or ``deep``, and the fill an
``sssp.fill_preds`` span. Every blocking read of the loop is counted
(:func:`~gunrock_tpu_torch.enactor.host_read`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from ..enactor import (COUNTS, LoopStats, Timer, capacity_ladder, deep_rungs,
                       host_read, ladder_rung, record_iteration, span,
                       sweep_to_fixpoint)
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..ops.advance import expand, expand_inverse
from ..ops.kernels import (last_hit_rows, reduce_by_dst_sorted,
                           sample_sorted, sample_sorted2, scatter_sorted)
from ..ops.pull2 import pull_vertex_reduce
from ..ops.segment import frontier_from_mask
from ..utils.info import make_info

__all__ = ["sssp", "SsspResult", "sssp_device"]

INF = float("inf")
# Micro-loop rung (the JAX package's DEEP_CAP): deep entry needs
# fcap >= 2 * C, because the merged queue of a micro round is 2C wide.
DEEP_CAP = 8192
_F32_ONE = np.float32(1.0)
# The carry merge's id for lanes that hold no queue entry (above every
# vertex id, as the JAX package's SENT).
_SENTINEL = 2**31 - 1


@dataclasses.dataclass
class SsspResult:
    distances: np.ndarray          # (V,) float32, +inf unreachable
    preds: Optional[np.ndarray]    # (V,) int32 shortest-path tree parent
    info: dict


@dataclasses.dataclass
class _State:
    dist: torch.Tensor        # (v_pad,) float32, updated in place
    frontier: torch.Tensor    # sorted int32 queue of the first min(n, fcap)
    n: int                    # queue length (may pass fcap on overflow)
    m_f: int                  # degree sum of the queue
    active: torch.Tensor      # (v_pad,) bool far pile, updated in place
    level: np.float32         # near/far threshold
    stats: LoopStats


@dataclasses.dataclass(frozen=True)
class _Config:
    mode: str                 # "bellman" or "nearfar"
    delta: np.float32
    fcap: int                 # the JAX package's queue capacity
    caps: tuple               # push rungs (capacity_ladder)
    fused: bool
    pull_thresh: Optional[int]  # pull when m_f passes it (CUDA, blocked)
    rungs: tuple              # deep micro-loop widths, ascending
    max_iters: int
    carry: bool = False       # the deep micro-loop's value-carry rounds


def _degree_sum(graph: DeviceGraph, verts: torch.Tensor) -> int:
    """Out-degree sum of a vertex list: the JAX package's
    ``_laddered_mf`` (``models/sssp.py:73-94``), whose rung ladder only
    bounds a fixed-width gather; here the list is exact-size."""
    v = verts.long()
    host_read()
    return int((graph.row_offsets[v + 1] - graph.row_offsets[v]).sum())


def _relax_payload(graph: DeviceGraph, dist: torch.Tensor, ex):
    """(dst, w, dist[src]) of the expanded lanes, through kernel K5 on
    CUDA (its plain version on the CPU)."""
    dst, w = sample_sorted2(graph.col_indices, graph.edge_values, ex.eid)
    return dst, w, sample_sorted(dist, ex.src)


def _sort_keys(dst: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """One int64 key per lane that orders like ``(dst, cand)``: the
    destination in the high word, the float32 bits of ``cand`` mapped to
    an unsigned order in the low word (sign flipped for non-negative
    values, all bits for negative ones)."""
    bits = cand.view(torch.int32).long() & 0xFFFFFFFF
    low = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                      bits | 0x80000000)
    return (dst.long() << 32) | low


def _unsort_cand(keys: torch.Tensor) -> torch.Tensor:
    low = keys & 0xFFFFFFFF
    bits = torch.where(low >= 0x80000000, low ^ 0x80000000,
                       low ^ 0xFFFFFFFF)
    bits = torch.where(bits >= 0x80000000, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def _winner_minimize(dist: torch.Tensor, dst: torch.Tensor,
                     cand: torch.Tensor):
    """Deterministic scatter-min (``models/sssp.py:112-128``): sort lanes
    by ``(dst, cand)``, the head of each destination run carries its min,
    and heads that improve ``dist`` win and are written (in place).
    Returns ``(sorted_dst, win, sorted_cand)``; winners are ascending."""
    keys = torch.sort(_sort_keys(dst, cand)).values
    sd = (keys >> 32).to(torch.int32)
    sc = _unsort_cand(keys)
    head = torch.ones_like(sd, dtype=torch.bool)
    head[1:] = sd[1:] != sd[:-1]
    win = head & (sc < dist[sd.long()])
    dist[sd[win].long()] = sc[win]
    host_read(2)
    return sd, win, sc


def _winner_minimize_fused(dist: torch.Tensor, dst: torch.Tensor,
                           cand: torch.Tensor, out_lanes: int):
    """Fused winner resolution (``models/sssp.py:131-159``): one sort by
    destination, kernel K7 with the improving-only filter ``aux =
    dist[sd]`` (a K5 gather), whose output is the improving winners and
    their distances in ascending order, then kernel K8 writes them into
    ``dist`` in place. Returns ``(ids, count)``, count a device tensor;
    the distances are bitwise those of :func:`_winner_minimize`."""
    sd, order = torch.sort(dst, stable=True)
    sc = cand[order]
    ids, vals, count = reduce_by_dst_sorted(
        sd, sc, op="min", out_lanes=out_lanes, aux=sample_sorted(dist, sd))
    # count <= distinct improving destinations <= out_lanes: no clamp.
    scatter_sorted(dist, ids, vals, count=count, op="min")
    return ids, count


def _relax(graph: DeviceGraph, cfg: _Config, st: _State, cap: int):
    """One push round at rung ``cap`` (``models/sssp.py:181-230``):
    expand the first ``min(n, cap, fcap)`` queued vertices, keep the
    first ``cap`` lanes, relax, resolve winners. Returns the next queue
    (its first ``fcap``), its length and degree sum, the edge count and
    the overflow flag of the JAX package's capacities."""
    in_cap = min(cap, cfg.fcap)
    ex = expand(graph, st.frontier[:in_cap], with_dst=False)
    if ex.total > cap:
        ex = dataclasses.replace(ex, src=ex.src[:cap], eid=ex.eid[:cap],
                                 rank=ex.rank[:cap])
    dst, w, dsrc = _relax_payload(graph, st.dist, ex)
    cand = dsrc + w
    if cfg.fused:
        ids, count = _winner_minimize_fused(st.dist, dst, cand,
                                            min(cap, graph.v_pad))
        n_next = int(count)
        host_read()
        nf = ids[:min(n_next, cfg.fcap)]
    else:
        sd, win, _ = _winner_minimize(st.dist, dst, cand)
        winners = sd[win]
        host_read()
        n_next = winners.shape[0]
        nf = winners[:cfg.fcap]
    overflow = ex.total > cap or st.n > in_cap or n_next > cfg.fcap
    return nf, n_next, _degree_sum(graph, nf), ex.total, overflow


def _pull_relax(graph: DeviceGraph, cfg: _Config, st: _State):
    """Full-edge pull round (``models/sssp.py:233-253``) through kernel
    K3: ``cand[v]`` = min over in-edges of ``dist[u] + w`` with the
    sources outside the frontier masked to +inf; the improved vertices,
    ascending, are the next queue."""
    fmask = torch.zeros(graph.v_pad, dtype=torch.bool, device=st.dist.device)
    fmask[st.frontier.long()] = True
    table = torch.where(fmask, st.dist, INF)
    fresh = torch.minimum(st.dist, pull_vertex_reduce(table, graph, op="min",
                                                      wmode="add"))
    improved = fresh < st.dist
    st.dist.copy_(fresh)
    nf, n_next = frontier_from_mask(improved)
    edges = min(graph.num_edges, 2**31 - 1)
    return (nf[:cfg.fcap], n_next, _degree_sum(graph, nf), edges,
            n_next > cfg.fcap)


def _bisect(dist: torch.Tensor, delta: np.float32, level: np.float32,
            near: torch.Tensor, active: torch.Tensor):
    """Near-far threshold advance (``models/sssp.py:162-178``, the
    reference's Bisect): while the near bucket is empty and the pile is
    not, raise ``level`` by ``delta`` (float32) and re-split. The JAX
    package re-splits every step; the first level that catches a vertex
    is the first above the least distance in the pile, so one device
    reduction and a host loop of float32 adds give its levels. Returns
    ``(level, near, active)``; ``active`` is updated in place."""
    any_near, any_active, least = torch.stack([
        near.any().float(), active.any().float(),
        torch.where(active, dist, INF).min()]).tolist()
    host_read()
    if any_near or not any_active:
        return level, near, active
    least = np.float32(least)
    while True:
        nxt = np.float32(level + delta)
        if nxt == level:
            raise ValueError(f"delta {delta} does not move the near-far "
                             f"threshold {level}")
        level = nxt
        if least < level:
            break
    near = active & (dist < float(level))
    active &= ~near
    return level, near, active


def _next_near(graph: DeviceGraph, cfg: _Config, st: _State,
               near: torch.Tensor) -> bool:
    """Queue the near bucket (ascending); returns the overflow flag."""
    frontier, st.n = frontier_from_mask(near)
    st.frontier = frontier[:cfg.fcap]
    st.m_f = _degree_sum(graph, frontier)
    return st.n > cfg.fcap


def _general_round(graph: DeviceGraph, cfg: _Config, st: _State) -> str:
    """One round of the general path: a full pull when the frontier's
    edge volume passes the threshold, else a push at the ladder rung of
    ``max(m_f, n)``; in near-far mode the improved vertices join the pile
    and the near bucket becomes the frontier
    (``models/sssp.py:468-511``). Returns the phase."""
    pull = cfg.pull_thresh is not None and st.m_f > cfg.pull_thresh
    if pull:
        nf, n, m_f, edges, overflow = _pull_relax(graph, cfg, st)
    else:
        cap = ladder_rung(list(cfg.caps), max(st.m_f, st.n))
        nf, n, m_f, edges, overflow = _relax(graph, cfg, st, cap)
    if cfg.mode == "nearfar":
        st.active[nf.long()] = True
        near = st.active & (st.dist < float(st.level))
        st.active &= ~near
        st.level, near, st.active = _bisect(st.dist, cfg.delta, st.level,
                                            near, st.active)
        overflow = _next_near(graph, cfg, st, near) or overflow
    else:
        st.frontier, st.n, st.m_f = nf, n, m_f
    record_iteration(st.stats, frontier_len=st.n, edges=edges,
                     overflow=overflow)
    return "pull" if pull else "push"


def _split_near(cfg: _Config, st: _State, dq: torch.Tensor):
    """The micro round's near set and threshold
    (``models/sssp.py:343-362``): queued vertices below ``level``; when
    there are none, the round relaxes nothing and the threshold jumps
    past the least queued distance in one shot, in float32."""
    near = dq < float(st.level)
    any_near, least = torch.stack([near.any().float(), dq.min()]).tolist()
    host_read()
    if not any_near:
        least = np.float32(least)
        k = np.maximum(np.floor((least - st.level) / cfg.delta) + _F32_ONE,
                       _F32_ONE)
        jumped = np.float32(st.level + k * cfg.delta)
        if not jumped > least:
            jumped = np.nextafter(least, np.float32(np.inf))
        st.level = jumped
    return near, bool(any_near)


def _micro_round(graph: DeviceGraph, cfg: _Config, st: _State) -> None:
    """One deep micro round (``models/sssp.py:311-341``, ``carry=False``):
    relax the near subset of the queue (all of it in bellman mode), then
    the new queue is the far rest merged with the winners, deduplicated
    and ascending."""
    q = st.frontier
    if cfg.mode == "nearfar":
        near, any_near = _split_near(cfg, st, st.dist[q.long()])
    else:
        near, any_near = None, True
    edges = 0
    if any_near:
        nq = q if near is None else q[near]
        ex = expand(graph, nq, with_dst=False)
        dst, w, dsrc = _relax_payload(graph, st.dist, ex)
        sd, win, _ = _winner_minimize(st.dist, dst, dsrc + w)
        far = q[:0] if near is None else q[~near]
        q = torch.unique(torch.cat([far, sd[win]]))
        host_read(2 if near is None else 4)
        edges = ex.total
    st.frontier, st.n = q, q.shape[0]
    st.m_f = _degree_sum(graph, q)
    record_iteration(st.stats, frontier_len=st.n, edges=edges)


def _micro_round_carry(graph: DeviceGraph, cfg: _Config, st: _State,
                       qd: torch.Tensor, qg: torch.Tensor,
                       deg: torch.Tensor):
    """One deep micro round with value-carry (``micro_body_carry``,
    ``models/sssp.py:364-424``): the queue's distances ``qd`` and
    out-degrees ``qg`` ride beside it, so the round reads no V-scale
    array for them. The near subset's ``(dst, w)`` come through kernel
    K5's two-array mode, ``dist[src]`` is a take from the carried
    distances by ``rank``, and the merge keeps each id's least distance
    (exact: every improvement re-enters the queue as a winner). Only the
    winners' degrees are gathered, from ``deg``, the out-degrees. Returns
    the new ``(qd, qg)``."""
    q = st.frontier
    if cfg.mode == "nearfar":
        near, any_near = _split_near(cfg, st, qd)
    else:
        near, any_near = None, True
    edges = 0
    if any_near:
        if near is None:
            nq, ndq, far = q, qd, torch.zeros_like(q, dtype=torch.bool)
        else:
            nidx = torch.nonzero(near).squeeze(1)
            host_read()
            nq, ndq, far = q[nidx], qd[nidx], ~near
        ex = expand(graph, nq, with_dst=False)
        dst, w = sample_sorted2(graph.col_indices, graph.edge_values, ex.eid)
        sd, win, sc = _winner_minimize(st.dist, dst, ndq[ex.rank] + w)
        wdeg = deg[sd.long()]
        # The merge: the far queue, then the winners, the lanes that left
        # or lost as sentinels, sorted by id alone (stably). A winner's
        # distance is below its queued one (it improved on it), so each
        # id's run tail, the winner where there is one, carries the
        # least: the entry the JAX package's (id, dist) sort keeps.
        sid, order = torch.sort(torch.cat([torch.where(far, q, _SENTINEL),
                                           torch.where(win, sd, _SENTINEL)]),
                                stable=True)
        keep = sid < _SENTINEL
        keep[:-1] &= sid[:-1] != sid[1:]
        kidx = torch.nonzero(keep).squeeze(1)
        host_read()
        o = order[kidx]
        q = sid[kidx]
        qd = torch.cat([qd, sc])[o]
        qg = torch.cat([qg, wdeg])[o]
        edges = ex.total
    st.frontier, st.n = q, q.shape[0]
    st.m_f = int(qg.sum())
    host_read()
    record_iteration(st.stats, frontier_len=st.n, edges=edges)
    return qd, qg


def _refill(graph: DeviceGraph, cfg: _Config, st: _State) -> None:
    """After a near-far stretch drains its queue: raise the threshold
    until the far pile yields a near bucket, and queue it
    (``models/sssp.py:448-463``)."""
    empty = torch.zeros_like(st.active)
    st.level, near, st.active = _bisect(st.dist, cfg.delta, st.level, empty,
                                        st.active)
    if _next_near(graph, cfg, st, near):
        st.stats.overflow = True


def _deep_stretch(graph: DeviceGraph, cfg: _Config, st: _State, C: int,
                  instrument: Optional[list], t0: list) -> None:
    """Micro rounds at rung ``C`` while the queue and its edge volume fit
    it (``models/sssp.py:272-465``); in near-far mode a drained queue is
    refilled from the far pile, which ends the stretch. With
    ``cfg.carry`` the stretch gathers the queue's distances and degrees
    once (``models/sssp.py:428-437``) and carries them through its
    rounds."""
    if cfg.carry:
        deg = graph.out_degrees()
        q = st.frontier.long()
        qd, qg = st.dist[q], deg[q]
    while (0 < st.n <= C and st.m_f <= C and not st.stats.overflow
           and st.stats.iteration < cfg.max_iters):
        with span("sssp.round", kind="deep"):
            if cfg.carry:
                qd, qg = _micro_round_carry(graph, cfg, st, qd, qg, deg)
            else:
                _micro_round(graph, cfg, st)
            refill = False
            if cfg.mode == "nearfar" and st.n == 0:
                refill = bool(st.active.any())
                host_read()
            if refill:
                _refill(graph, cfg, st)
        _record(instrument, st, "deep", t0)
        if refill:
            return


def _record(instrument: Optional[list], st: _State, phase: str,
            t0: list) -> None:
    """One ``instrument`` record a round (``models/sssp.py:804-822``),
    timed to a device fence."""
    if instrument is None:
        return
    sync(st.dist.device)
    t1 = time.perf_counter()
    instrument.append({"iteration": st.stats.iteration,
                       "ms": (t1 - t0[0]) * 1e3, "frontier": st.n,
                       "m_f": st.m_f, "phase": phase})
    t0[0] = t1


def _pull_divisor() -> int:
    """Pull when m_f > E / div (``GUNROCK_SSSP_PULL_DIV``, default 16)."""
    return max(1, int(os.environ.get("GUNROCK_SSSP_PULL_DIV", "16")))


def _fill_preds(graph: DeviceGraph, dist: torch.Tensor,
                src: int) -> torch.Tensor:
    """Shortest-path-tree parents (the JAX package's
    ``models/sssp.py:623-638``, repaired): pred(v) = the last in-neighbour
    u in CSC order that is strictly nearer, ``dist[u] < dist[v]``, with
    ``dist[u] + w(u, v) == dist[v]``, exact because every distance was
    produced as such a sum; -1 at ``src`` and where unreached. Along
    such parents the distance falls, so they form no cycle. A reached
    vertex with no such hit has only equally far ones (a weight of 0, or
    one the float32 add absorbs): :func:`_fill_ties` gives it a parent
    already in the tree. The last hits come from
    :func:`~gunrock_tpu_torch.ops.kernels.last_hit_rows` with int64
    positions (kernel K14 on the card), as BFS's fill
    (``models/bfs.py``)."""
    with span("sssp.fill_preds"):
        last = last_hit_rows(graph, dist, graph.csc_edge_values)
        reached = torch.isfinite(dist)
        reached[src] = False
        fill = graph.csc_indices[last.clamp(min=0)]
        preds = torch.where(reached & (last >= 0), fill, -1).to(torch.int32)
        ties = torch.nonzero(reached & (last < 0)).squeeze(1)
        host_read()
        if ties.numel():
            _fill_ties(graph, dist, preds, ties)
    return preds


def _fill_ties(graph: DeviceGraph, dist: torch.Tensor, preds: torch.Tensor,
               ties: torch.Tensor) -> None:
    """Parents for the reached vertices ``ties`` that have no strictly
    nearer hit (updates ``preds`` in place): in rounds over just those
    vertices, each takes the last in-neighbour in CSC order with
    ``dist[u] + w == dist[v]`` that is not itself among the ties still
    open at the round's start (the source, a vertex with a strictly
    nearer parent, or a tie settled in an earlier round), so no round
    closes a cycle. Every such distance was last lowered from a vertex
    that held it already, so each round settles at least one tie; a
    round that settles none (distances no relaxation produced) leaves
    the rest at -1."""
    open_ = torch.zeros(dist.shape[0], dtype=torch.bool, device=dist.device)
    open_[ties] = True
    while ties.numel():
        ex = expand_inverse(graph, ties.to(torch.int32))
        ok = (dist[ex.dst.long()] + graph.csc_edge_values[ex.eid]
              == dist[ties[ex.rank]]) & ~open_[ex.dst.long()]
        best = torch.full(ties.shape, -1, dtype=torch.int64,
                          device=dist.device)
        best.scatter_reduce_(0, ex.rank, torch.where(ok, ex.eid, -1), "amax")
        settled = best >= 0
        preds[ties] = torch.where(settled,
                                  graph.csc_indices[best.clamp(min=0)], -1)
        open_[ties] = ~settled
        left = ties[~settled]
        host_read()
        if left.numel() == ties.numel():
            return
        ties = left


def _sssp_pull_sweeps(graph: DeviceGraph, src: int, *,
                      max_iters: Optional[int], instrument: Optional[list]):
    """The sweep route (``models/sssp.py:663-718``): min-pull sweeps with
    ``add``/``val`` from ``src`` in calls of ``GUNROCK_SSSP_SWEEPS`` (6)
    to the fixpoint. Returns ``(dist, stats)``, or None on the bail-out
    (:func:`~gunrock_tpu_torch.enactor.sweep_to_fixpoint`)."""
    if graph.csc_edge_values is None:
        raise ValueError("the sweep route needs the CSC's edge values: "
                         "to_device(with_edge_values=True, with_csc=True "
                         "or with_blocked_values=True)")
    rounds = int(os.environ.get("GUNROCK_SSSP_SWEEPS", "6"))
    init = torch.full((graph.v_pad,), INF, device=graph.device)
    init[src] = 0.0
    out = sweep_to_fixpoint(graph, init, wmode="add", rounds=rounds,
                            budget=16384 if max_iters is None else max_iters,
                            instrument=instrument)
    if out is None:
        return None
    dist, changed = out
    stats = LoopStats(iteration=len(changed), nodes_queued=sum(changed),
                      edges_queued=graph.num_edges * len(changed),
                      frontier_trace=changed, route="pull_sweeps")
    return dist, stats


def sssp_device(graph: DeviceGraph, src: int, *, mark_preds: bool = False,
                mode: str = "bellman", delta: float = 1.0,
                queue_sizing: float = 1.0, max_iters: Optional[int] = None,
                instrument: Optional[list] = None,
                fused: Optional[bool] = None,
                deep_carry: Optional[bool] = None):
    """SSSP on an uploaded graph; returns ``(dist, preds, stats)``: the
    (v_pad,) float32 distances (+inf unreached) and int32 parents (None
    without ``mark_preds``) on the graph's device, and the
    :class:`~gunrock_tpu_torch.enactor.LoopStats`, whose ``route`` names
    the path taken.

    ``mode`` is ``bellman``, ``nearfar`` (with ``delta``) or ``pull``
    (see the module docstring). ``queue_sizing`` (at most 1) scales the
    JAX package's queue and lane capacities, which decide the deep
    micro-loop, the fused kernel's output lanes and the overflow stop.
    ``fused`` defaults to CUDA with ``GUNROCK_SSSP_FUSED=1``.
    ``deep_carry`` runs the deep micro-loop's value-carry rounds
    (:func:`_micro_round_carry`); it defaults to ``GUNROCK_SSSP_CARRY=1``
    (off), as in the JAX package, and changes no result, round or count.
    ``instrument``: pass a list to collect one record a round,
    ``{iteration, ms, frontier, m_f, phase}`` with phase ``deep``,
    ``pull``, ``push`` or ``pull_sweeps`` (one a sweep call)."""
    if graph.edge_values is None:
        raise ValueError("SSSP needs to_device(with_edge_values=True)")
    if not 0 <= src < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if mark_preds and graph.csc_edge_values is None:
        raise ValueError("mark_preds needs the CSC's edge values: "
                         "to_device(with_edge_values=True, with_csc=True)")
    if mode not in ("bellman", "nearfar", "pull"):
        raise ValueError(f"unknown mode {mode!r}")
    on_cuda = graph.device.type == "cuda"
    route = mode
    if mode == "bellman" and graph.has_pull2 and \
            os.environ.get("GUNROCK_SSSP_PULL2", "1") == "1":
        mode = "pull"
    if mode == "pull":
        out = _sssp_pull_sweeps(graph, src, max_iters=max_iters,
                                instrument=instrument)
        if out is not None:
            dist, stats = out
            return (dist, _fill_preds(graph, dist, src) if mark_preds
                    else None, stats)
        # The high-diameter bail-out: near-far takes the traversal over.
        mode, route = "nearfar", "bailed_to_nearfar"
    sizing = min(queue_sizing, 1.0)
    fcap = max(128, int(graph.v_pad * sizing))
    out_cap = max(128, int(graph.e_pad * sizing))
    caps = capacity_ladder(out_cap, step=4)
    if fused is None:
        fused = on_cuda and os.environ.get("GUNROCK_SSSP_FUSED", "0") == "1"
    if deep_carry is None:
        deep_carry = os.environ.get("GUNROCK_SSSP_CARRY", "0") == "1"
    if fused:
        # The JAX package's finer rungs below 4M lanes for the fused round.
        caps = capacity_ladder(min(out_cap, 1 << 22), step=2) + \
            [c for c in caps if c > (1 << 22)]
    rungs = ()
    if os.environ.get("GUNROCK_SSSP_DEEP", "1") == "1":
        rungs = tuple(c for c in deep_rungs("GUNROCK_SSSP_DEEP_RUNGS",
                                            DEEP_CAP) if fcap >= 2 * c)
    pull_thresh = None
    if on_cuda and graph.k3_pulls:
        pull_thresh = max(1, min(graph.num_edges // _pull_divisor(), 2**30))
    cfg = _Config(mode=mode, delta=np.float32(delta), fcap=fcap,
                  caps=tuple(caps), fused=fused, pull_thresh=pull_thresh,
                  rungs=rungs, carry=deep_carry,
                  max_iters=4 * graph.num_nodes + 16 if max_iters is None
                  else max_iters)
    dev = graph.device
    dist = torch.full((graph.v_pad,), INF, device=dev)
    dist[src] = 0.0
    start, end = graph.row_offsets[src:src + 2].tolist()
    host_read()
    st = _State(dist=dist, frontier=torch.tensor([src], dtype=torch.int32,
                                                 device=dev),
                n=1, m_f=min(end - start, 2**31 - 1),
                active=torch.zeros(graph.v_pad, dtype=torch.bool, device=dev),
                level=cfg.delta if mode == "nearfar" else np.float32(0.0),
                stats=LoopStats(route=route))
    t0 = [time.perf_counter()]
    while st.n > 0 and st.stats.iteration < cfg.max_iters and \
            not st.stats.overflow:
        size = max(st.m_f, st.n)
        if rungs and size <= rungs[-1]:
            C = next(c for c in rungs if size <= c)
            _deep_stretch(graph, cfg, st, C, instrument, t0)
        else:
            with span("sssp.round") as rnd:
                phase = _general_round(graph, cfg, st)
                rnd.set(kind=phase)
            _record(instrument, st, phase, t0)
    preds = _fill_preds(graph, st.dist, src) if mark_preds else None
    return st.dist, preds, st.stats


def sssp(graph: Union[CsrGraph, DeviceGraph], src: Union[int, str] = 0, *,
         mark_preds: bool = False, mode: str = "bellman",
         delta_factor: float = 32.0, queue_sizing: float = 1.0,
         max_iters: Optional[int] = None, instrumented: bool = False,
         deep_carry: Optional[bool] = None, device="cuda") -> SsspResult:
    """Run SSSP from ``src`` (C API parity: ``gunrock_sssp``,
    ``gunrock.h:253``; ``mark_preds`` = MARK_PATHS). A :class:`CsrGraph`
    without edge values gets ``random_edge_values()``, ``delta`` is
    ``delta_factor`` times its mean edge value, and it is uploaded to
    ``device`` ``with_edge_values`` (``with_csc`` for ``mark_preds``), as
    the JAX package does; a :class:`DeviceGraph` runs where it lies, with
    ``delta`` 1.0. ``instrumented`` collects per-round records into
    ``info["per_iteration"]``; ``deep_carry`` goes to
    :func:`sssp_device`.

    Each call is the root span ``sssp``. Its run record holds the splits
    ``process_ms`` (the traversal and the fill), ``copy_ms`` (distances
    and preds to the host) and ``record_ms`` (the edges visited and the
    run record; set after :func:`make_info` returns), and
    ``host_reads``, the traversal's blocking device-to-host reads
    (:data:`~gunrock_tpu_torch.enactor.COUNTS`)."""
    with span("sssp"):
        timer = Timer("sssp")
        per_iter: Optional[list] = [] if instrumented else None
        num_nodes = graph.num_nodes
        delta = 1.0
        if isinstance(graph, CsrGraph):
            dev = resolve_device(device)
            if src == "largestdegree":
                src = graph.largest_degree_vertex()
            if graph.edge_values is None:
                graph.random_edge_values()
            if graph.num_edges:
                delta = delta_factor * float(np.mean(graph.edge_values))
            with timer.time("preprocess_ms"):
                dgraph = to_device(graph, with_edge_values=True,
                                   with_csc=mark_preds, device=dev)
                sync(dev)
        else:
            dgraph = graph
        src = int(src)
        if not 0 <= src < num_nodes:
            raise ValueError(f"src {src} out of range [0, {num_nodes})")
        with timer.time("process_ms"):
            reads0 = COUNTS["host_reads"]
            dist, preds, stats = sssp_device(
                dgraph, src, mark_preds=mark_preds, mode=mode, delta=delta,
                queue_sizing=queue_sizing, max_iters=max_iters,
                instrument=per_iter, deep_carry=deep_carry)
            host_reads = COUNTS["host_reads"] - reads0
            sync(dgraph.device)
        with timer.time("copy_ms"):
            dist_np = dist[:num_nodes].cpu().numpy()
            preds_np = preds[:num_nodes].cpu().numpy() if mark_preds \
                else None
        with timer.time("record_ms"):
            degs = np.diff(dgraph.row_offsets[:num_nodes + 1].cpu().numpy()
                           .astype(np.int64))
            info = make_info(
                primitive="sssp", graph=dgraph, stats=stats, timer=timer,
                edges_visited=int(degs[np.isfinite(dist_np)].sum()),
                extra={"src": src, "mark_paths": mark_preds, "mode": mode,
                       "instrumented": instrumented,
                       "search_depth": stats.iteration,
                       "host_reads": host_reads,
                       **({"per_iteration": per_iter}
                          if instrumented else {})},
            )
        info["record_ms"] = timer.splits["record_ms"] * 1000.0
        return SsspResult(distances=dist_np, preds=preds_np, info=info)
