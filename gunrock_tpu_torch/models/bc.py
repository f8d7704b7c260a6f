"""Betweenness centrality (Brandes: a forward and a backward level pass).

Counterpart of :mod:`gunrock_tpu.models.bc` (reference
``gunrock/app/bc/``): a BFS-like forward phase accumulates the
shortest-path counts ``sigma`` (``bc_functor.cuh:70-71``), then a backward
phase replays the levels deepest first, accumulating the dependencies
``delta[u] += sigma[u] / sigma[v] * (1 + delta[v])``
(``bc_functor.cuh:203-238``). The levels are replayed from one stable
argsort of the vertices by depth (:func:`_level_replay`). Routes, as in the
JAX package:

  * kernel C (:func:`_bc_pull2`): an undirected graph with ``has_pull2``
    runs both phases as level-gated sum pulls through kernel K9, in calls
    of ``GUNROCK_BC_LEVELS`` (8) levels with one host read of the counts
    a call (``GUNROCK_BC_PULL2``, default on).
  * the hybrid loop (:func:`_bc_hybrid`): push levels (expand, claim
    dedup, scatters); on CUDA graphs uploaded ``with_blocked_values`` or
    past 2^31 edges (``DeviceGraph.k3_pulls``), a level whose frontier
    edges pass ``E / 32`` pulls through kernel K3 instead. ``fused``
    resolves push levels with kernels K5, K7 and K8 after one sort
    (``GUNROCK_BC_FUSED``, CUDA).
  * the all-pull route (:func:`_bc_pull`): instrumented runs on the
    same CUDA graphs, one K3 pull a level.

Routing follows the JAX package's, with "the graph's tensors lie on CUDA"
where it reads "the backend is a TPU"; on the CPU the port takes the JAX
package's CPU routing, which the parity tests compare. The JAX package
runs its loops on the device in chunks of levels; here they run on the
host, one level at a time (K9: one call of levels), and the state is
updated in place. Outputs are scaled by 0.5 (the undirected double
count), as the reference's CPU validation (``tests/bc/test_bc.cu``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from ..enactor import LoopStats, Timer, capacity_ladder, ladder_rung, \
    record_iteration
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, resolve_device, sync, to_device
from ..ops.advance import expand
from ..ops.kernels import reduce_by_dst_sorted, sample_sorted, scatter_sorted
from ..ops.pull2 import (brandes_bwd_levels, brandes_fwd_levels,
                         pull_vertex_reduce)
from ..ops.segment import (compact, dedup_winners, frontier_from_mask,
                           scatter_add, scatter_set)
from ..utils.info import make_info

__all__ = ["bc", "BcResult", "bc_device"]

INF = float("inf")


@dataclasses.dataclass
class BcResult:
    bc_values: np.ndarray    # (V,) float32 centrality
    sigmas: np.ndarray       # (V,) float32 shortest-path counts (last src)
    labels: np.ndarray       # (V,) int32 BFS depth (last src), -1 unreached
    info: dict


@dataclasses.dataclass(frozen=True)
class _Config:
    fcap: int          # the JAX package's queue capacity
    caps: tuple        # push rungs (capacity_ladder)
    pallas: bool       # big levels pull through K3 (CUDA, blocked values)
    fused: bool        # push levels through K5, K7 and K8
    pull_thresh: int   # pull when the frontier's edges pass it


def _degree_sum(graph: DeviceGraph, verts: torch.Tensor) -> int:
    """Out-degree sum of a vertex list (``_frontier_edges``)."""
    v = verts.long()
    return int((graph.row_offsets[v + 1] - graph.row_offsets[v]).sum())


def _expand(graph: DeviceGraph, frontier: torch.Tensor, cap: int, *,
            with_dst: bool = True):
    """The advance of the JAX package's rung ``cap``: its first ``cap``
    lanes; ``total`` stays the true lane count."""
    ex = expand(graph, frontier, with_dst=with_dst)
    if ex.total <= cap:
        return ex
    return dataclasses.replace(
        ex, src=ex.src[:cap], eid=ex.eid[:cap], rank=ex.rank[:cap],
        dst=None if ex.dst is None else ex.dst[:cap])


def _fwd_push(graph, labels, sigma, frontier, depth, cap):
    """One forward push level (``models/bc.py:79-95``): claim-dedup the
    undiscovered destinations, label them, and add every lane's source
    count into the destinations at ``depth``. Returns the new vertices in
    lane order and their count."""
    ex = _expand(graph, frontier, cap)
    is_new = labels[ex.dst.long()] == -1
    keep = dedup_winners(ex.dst, is_new, graph.v_pad)
    scatter_set(labels, ex.dst, depth, mask=keep)
    contrib = labels[ex.dst.long()] == depth
    scatter_add(sigma, ex.dst, sigma[ex.src.long()], mask=contrib)
    nf, n = compact(ex.dst, keep)
    return nf, n, ex.total


def _fwd_push_fused(graph, labels, sigma, frontier, depth, cap):
    """The fused forward level (``models/bc.py:98-166``): destinations and
    source counts through K5, one sort by destination, K7's sum of the
    NEGATED counts with the filter ``aux = +inf`` where the destination
    is undiscovered, else ``-inf`` (a count that overflows to -inf still
    passes), then K8 sets labels and counts. The new vertices come out
    ascending."""
    ex = _expand(graph, frontier, cap, with_dst=False)
    dst = sample_sorted(graph.col_indices, ex.eid)
    sig_src = sample_sorted(sigma, ex.src)
    sd, order = torch.sort(dst, stable=True)
    aux = torch.where(labels[sd.long()] == -1, INF, -INF)
    out_lanes = min(cap, graph.v_pad)
    ids, csum, count = reduce_by_dst_sorted(sd, -sig_src[order], op="sum",
                                            out_lanes=out_lanes, aux=aux)
    scatter_sorted(labels, ids, torch.full((out_lanes,), depth,
                                           dtype=torch.int32,
                                           device=ids.device),
                   count=count, op="set")
    scatter_sorted(sigma, ids, -csum, count=count, op="set")
    n = int(count)
    return ids[:n], n, ex.total


def _fwd_level_pull(graph, labels, sigma, depth) -> torch.Tensor:
    """sigma[v] = sum of sigma over in-neighbours one level up, through
    K3 (``models/bc.py:175-183``); labels and sigma in place. Returns the
    mask of the newly discovered vertices."""
    contrib = torch.where(labels == depth - 1, sigma, 0.0)
    s = pull_vertex_reduce(contrib, graph, op="sum", wmode="none")
    new = (labels == -1) & (s > 0)
    labels.masked_fill_(new, depth)
    sigma.copy_(torch.where(new, s, sigma))
    return new


def _bwd_level_pull(graph, labels, sigma, delta, t) -> torch.Tensor:
    """delta[u] = sigma[u] * sum over neighbours one level down of
    (1 + delta) / sigma, for the level-``t`` ring, through K3
    (``models/bc.py:186-194``)."""
    contrib = torch.where(labels == t + 1,
                          (1.0 + delta) / sigma.clamp(min=1e-30), 0.0)
    acc = pull_vertex_reduce(contrib, graph, op="sum", wmode="none")
    return torch.where(labels == t, sigma * acc, delta)


def _bwd_push(graph, labels, sigma, delta, frontier, t, cap):
    """One backward push ring (``models/bc.py:270-285``); delta in
    place."""
    ex = _expand(graph, frontier, cap)
    dst = ex.dst.long()
    down = labels[dst] == t + 1
    sig_dst = torch.where(down, sigma[dst], 1.0)
    add = torch.where(down, sigma[ex.src.long()] / sig_dst
                      * (1.0 + delta[dst]), 0.0)
    scatter_add(delta, ex.src, add, mask=down)


def _bwd_push_fused(graph, labels, sigma, delta, frontier, t, cap):
    """The fused backward ring (``models/bc.py:287-325``): K7 sums
    ``(1 + delta[v]) / sigma[v]`` by source (the ring is ascending, so
    the sources are), the ``sigma[u]`` factor is applied per source, and
    K8 adds the result into delta in place."""
    ex = _expand(graph, frontier, cap, with_dst=False)
    dst = sample_sorted(graph.col_indices, ex.eid).long()
    down = labels[dst] == t + 1
    sig_dst = torch.where(down, sigma[dst], 1.0)
    add = torch.where(down, (1.0 + delta[dst]) / sig_dst, 0.0)
    out_lanes = min(cap, graph.v_pad) + 128
    ids, csum, count = reduce_by_dst_sorted(ex.src, add, op="sum",
                                            out_lanes=out_lanes)
    ok = torch.arange(out_lanes, device=ids.device) < count
    ids_c = torch.where(ok, ids, graph.v_pad - 1)
    vals = torch.where(ok, sigma[ids_c.long()] * csum, 0.0)
    scatter_sorted(delta, ids, vals, count=count, op="add")


def _level_replay(labels: torch.Tensor, max_depth: int):
    """Vertices sorted by depth (a stable argsort, so ascending within a
    level) and the first sorted index of each depth 0 .. max_depth (the
    reference's ``forward_queue_offsets``, ``models/bc.py:242-254``)."""
    key = torch.where(labels >= 0, labels, 2**30)
    order = torch.argsort(key, stable=True).to(torch.int32)
    depths = torch.arange(max_depth + 1, dtype=key.dtype,
                          device=labels.device)
    offsets = torch.searchsorted(key[order.long()], depths).tolist()
    return order, offsets


def _record(instrument: Optional[list], dev, t0: list, rec: dict) -> None:
    """One ``instrument`` record, timed to a device fence."""
    if instrument is None:
        return
    sync(dev)
    t1 = time.perf_counter()
    instrument.append({**rec, "ms": (t1 - t0[0]) * 1e3})
    t0[0] = t1


def _bc_hybrid(graph: DeviceGraph, src: int, cfg: _Config,
               instrument: Optional[list] = None):
    """The hybrid Brandes loop (``models/bc.py:197-472``): each level
    pushes at the JAX package's rung for its frontier's edge count, or
    pulls (``cfg.pallas``) when that count passes ``cfg.pull_thresh``.
    The forward phase stops when a level finds nothing or a capacity
    overflows; ``instrument`` gets one record a level of each phase."""
    dev = graph.device
    edges_all = min(graph.num_edges, 2**31 - 1)
    labels = torch.full((graph.v_pad,), -1, dtype=torch.int32, device=dev)
    labels[src] = 0
    sigma = torch.zeros(graph.v_pad, dtype=torch.float32, device=dev)
    sigma[src] = 1.0
    frontier = torch.tensor([src], dtype=torch.int32, device=dev)
    n = 1
    stats = LoopStats(route="hybrid")
    push = _fwd_push_fused if cfg.fused else _fwd_push
    t0 = [time.perf_counter()]
    while n > 0 and not stats.overflow:
        depth = stats.iteration + 1
        m_f = _degree_sum(graph, frontier)
        if cfg.pallas and m_f > cfg.pull_thresh:
            new = _fwd_level_pull(graph, labels, sigma, depth)
            nf, n = frontier_from_mask(new)
            edges, overflow = edges_all, n > cfg.fcap
        else:
            cap = ladder_rung(list(cfg.caps), m_f)
            nf, n, edges = push(graph, labels, sigma, frontier, depth, cap)
            overflow = edges > cap
        frontier = nf[:cfg.fcap]
        record_iteration(stats, frontier_len=n, edges=edges,
                         overflow=overflow)
        _record(instrument, dev, t0, {"phase": "forward",
                                      "level": stats.iteration,
                                      "frontier": n})
    max_depth = stats.iteration
    order, offsets = _level_replay(labels, max_depth)
    delta = torch.zeros(graph.v_pad, dtype=torch.float32, device=dev)
    bpush = _bwd_push_fused if cfg.fused else _bwd_push
    t0 = [time.perf_counter()]
    for t in range(max_depth - 1, -1, -1):
        ring = order[offsets[t]:min(offsets[t + 1], offsets[t] + cfg.fcap)]
        m_f = _degree_sum(graph, ring)
        if cfg.pallas and m_f > cfg.pull_thresh:
            delta = _bwd_level_pull(graph, labels, sigma, delta, t)
        else:
            bpush(graph, labels, sigma, delta, ring, t,
                  ladder_rung(list(cfg.caps), m_f))
        _record(instrument, dev, t0, {"phase": "backward", "level": t})
    delta[src] = 0.0
    return delta, sigma, labels, stats


def _reached_stats(graph: DeviceGraph, labels: torch.Tensor, depth: int,
                   route: str, trace: Optional[list] = None) -> LoopStats:
    """Traversal stats of the pull routes: the forward phase visits every
    out-edge of each reached vertex once, so edges_queued is the degree
    sum over the reached set (the JAX package's accounting)."""
    reached = labels >= 0
    edges, nodes = torch.stack([
        torch.where(reached, graph.out_degrees(), 0).sum(),
        reached.sum()]).tolist()
    return LoopStats(iteration=depth, nodes_queued=nodes, edges_queued=edges,
                     frontier_trace=list(trace or []), route=route)


def _bc_pull(graph: DeviceGraph, src: int, instrument: Optional[list]):
    """All-pull Brandes (``models/bc.py:510-559``): one K3 pull a level of
    both phases; the forward phase ends with the first level that
    discovers nothing."""
    dev = graph.device
    labels = torch.full((graph.v_pad,), -1, dtype=torch.int32, device=dev)
    labels[src] = 0
    sigma = torch.zeros(graph.v_pad, dtype=torch.float32, device=dev)
    sigma[src] = 1.0
    d = 1
    t0 = [time.perf_counter()]
    while True:
        changed = int(_fwd_level_pull(graph, labels, sigma, d).sum())
        _record(instrument, dev, t0, {"phase": "forward", "level": d,
                                      "discovered": changed})
        d += 1
        if changed == 0:
            break
    depth = d - 1            # the last level, which discovered nothing
    delta = torch.zeros(graph.v_pad, dtype=torch.float32, device=dev)
    t0 = [time.perf_counter()]
    for t in range(depth - 1, -1, -1):
        delta = _bwd_level_pull(graph, labels, sigma, delta, t)
        _record(instrument, dev, t0, {"phase": "backward", "level": t})
    delta[src] = 0.0
    return delta, sigma, labels, _reached_stats(graph, labels, depth, "pull")


def _bc_pull2(graph: DeviceGraph, src: int, instrument: Optional[list]):
    """Kernel-C Brandes (``models/bc.py:571-629``): both phases through
    K9 in calls of ``GUNROCK_BC_LEVELS`` levels. The forward phase stops
    at the first level that discovers nothing (``depth`` is the last that
    did) or past ``num_nodes`` levels; the backward rings run from
    ``depth - 1`` down to 0."""
    dev = graph.device
    levels = max(1, int(os.environ.get("GUNROCK_BC_LEVELS", "8")))
    lab = torch.full((graph.v_pad,), INF, dtype=torch.float32, device=dev)
    lab[src] = 0.0
    sig = torch.zeros(graph.v_pad, dtype=torch.float32, device=dev)
    sig[src] = 1.0
    d = 1
    trace = []
    t0 = [time.perf_counter()]
    while True:
        lab, sig, chg = brandes_fwd_levels(graph, lab, sig, d0=d,
                                           levels=levels)
        chg = chg.tolist()
        _record(instrument, dev, t0, {"phase": "forward",
                                      "level": d + levels - 1,
                                      "discovered": sum(chg)})
        trace.extend(chg)
        if 0 in chg:
            depth = d + chg.index(0) - 1
            break
        d += levels
        if d > graph.num_nodes:
            depth = d - 1
            break
    delta = torch.zeros(graph.v_pad, dtype=torch.float32, device=dev)
    t = depth - 1
    t0 = [time.perf_counter()]
    while t >= 0:
        n = min(levels, t + 1)
        delta, _ = brandes_bwd_levels(graph, lab, sig, delta, t0=t, levels=n)
        _record(instrument, dev, t0, {"phase": "backward", "level": t})
        t -= n
    delta[src] = 0.0
    labels = torch.where(torch.isfinite(lab), lab, -1.0).to(torch.int32)
    return delta, sig, labels, _reached_stats(graph, labels, depth, "pull2",
                                              trace)


def bc_device(graph: DeviceGraph, src: int, *, queue_sizing: float = 1.0,
              instrument: Optional[list] = None,
              fused: Optional[bool] = None):
    """Single-source Brandes on an uploaded graph; returns ``(bc_vals,
    sigma, labels, stats)``: the (v_pad,) float32 dependencies with the
    source's zeroed (unscaled), the path counts, the int32 depths (-1
    unreached), all on the graph's device, and the
    :class:`~gunrock_tpu_torch.enactor.LoopStats`, whose ``route`` names
    the path taken (``pull2``, ``hybrid`` or ``pull``).

    ``queue_sizing`` (at most 1) scales the JAX package's queue and lane
    capacities; passing one stops the forward phase (``stats.overflow``).
    ``fused`` defaults to CUDA with ``GUNROCK_BC_FUSED=1``.
    ``instrument``: pass a list to collect one record a level (a call on
    the kernel-C route) of each phase."""
    if not 0 <= src < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if (graph.has_pull2 and graph.undirected
            and os.environ.get("GUNROCK_BC_PULL2", "1") == "1"):
        return _bc_pull2(graph, src, instrument)
    on_cuda = graph.device.type == "cuda"
    use_pallas = on_cuda and graph.k3_pulls
    if fused is None:
        fused = on_cuda and os.environ.get("GUNROCK_BC_FUSED", "0") == "1"
    if use_pallas and instrument is not None:
        return _bc_pull(graph, src, instrument)
    sizing = min(queue_sizing, 1.0)
    cfg = _Config(fcap=max(128, int(graph.v_pad * sizing)),
                  caps=tuple(capacity_ladder(
                      max(128, int(graph.e_pad * sizing)))),
                  pallas=use_pallas, fused=fused,
                  pull_thresh=max(1, min(graph.num_edges // 32, 2**30)))
    return _bc_hybrid(graph, src, cfg, instrument)


def bc(graph: Union[CsrGraph, DeviceGraph],
       src: Optional[Union[int, str]] = 0, *, queue_sizing: float = 1.0,
       instrumented: bool = False, device="cuda") -> BcResult:
    """Betweenness centrality (C API parity: ``gunrock_bc``,
    ``gunrock.h:200``). ``src=None`` or ``-1`` accumulates over all
    sources (exact BC), as the reference's ``--src=-1``. A
    :class:`CsrGraph` is uploaded to ``device`` as it is (the push loop);
    a :class:`DeviceGraph` runs where it lies, on the route its upload
    selects (see the module docstring). ``instrumented`` collects
    per-level records into ``info["per_iteration"]``."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        dev = resolve_device(device)
        if src == "largestdegree":
            src = graph.largest_degree_vertex()
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, device=dev)
            sync(dev)
    else:
        dgraph = graph
    if src is None or src == -1:
        sources = range(num_nodes)
    else:
        src = int(src)
        if not 0 <= src < num_nodes:
            raise ValueError(f"src {src} out of range [0, {num_nodes})")
        sources = [src]
    bc_acc = np.zeros(num_nodes, np.float64)
    with timer.time("process_ms"):
        for s in sources:
            bc_vals, sigma, labels, stats = bc_device(
                dgraph, s, queue_sizing=queue_sizing, instrument=per_iter)
            bc_acc += bc_vals[:num_nodes].cpu().numpy()
    info = make_info(
        primitive="bc", graph=dgraph, stats=stats, timer=timer,
        edges_visited=2 * int(stats.edges_queued) * len(sources),
        extra={"src": -1 if len(sources) > 1 else int(sources[0]),
               "instrumented": instrumented,
               "search_depth": stats.iteration,
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return BcResult(bc_values=(bc_acc * 0.5).astype(np.float32),
                    sigmas=sigma[:num_nodes].cpu().numpy(),
                    labels=labels[:num_nodes].cpu().numpy(), info=info)
