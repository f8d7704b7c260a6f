"""Breadth-first search and direction-optimized BFS (DO-BFS).

Counterpart of :mod:`gunrock_tpu.models.bfs` (reference
``gunrock/app/bfs/``): label-setting BFS with optional predecessors and
Beamer-style push/pull switching (``bfs_enactor.cuh:852-939``).

The JAX package compiles the traversal into one ``lax.while_loop``. Here
the loop runs on the host and reads the frontier count ``n`` and its
degree sum ``m_f`` once per level; every other step stays on the device.
The push/pull decisions are the JAX package's, level for level:

  * The direction vote (``models/bfs.py:473-480``) in float32, with the
    pull-entry threshold chosen by ``fvalid``.
  * ``fvalid`` (is the frontier queue materialized) depends on the push
    rung the JAX package would have dispatched to: the smallest entry of
    ``capacity_ladder(out_cap)`` at least ``max(m_f, n)``, ``out_cap``
    being ``e_pad * min(queue_sizing, 1)``. Tensors here are exact-size,
    so the rung is computed on the host only for that rule and for the
    overflow rule below. A rung of at least ``v_pad // 4`` leaves the
    queue unmaterialized.
  * Queue overflow (``models/bfs.py:145-196``): a push level overflows
    where the JAX package's fixed-size queues would have cut it, that is
    when its expanded edges pass the rung, its next frontier passes the
    queue capacity ``fcap`` or a queue rebuild passes ``min(rung,
    fcap)``. The traversal stops there, and :func:`bfs` reruns it with
    ``queue_sizing`` doubled, up to 4, as the JAX package does.

The deep micro-loop (``models/bfs.py:225-318,498-554``) runs whole
stretches of small levels, DO or not, ahead of the vote: whenever
``max(m_f, n)`` fits the largest micro rung. The rungs are
``GUNROCK_BFS_DEEP_RUNGS`` (default ``DEEP_CAP`` = 8192), each kept only
if the JAX package's queue capacity ``fcap`` holds it; ``fcap`` is
``queue_sizing`` times ``v_pad // 4`` (DO) or ``v_pad``, at most
``v_pad`` and at least 128.
``GUNROCK_BFS_DEEP`` defaults to ``"1"``, the JAX package's rule off a
TPU. A micro round keeps, for each new vertex, the first lane of its
run after a stable sort by destination: the smallest source.

Push levels filter through the bitmask-gather kernel (K2). Pull levels
take one of two routes, as the JAX package's accelerator route does: on
graphs with ``has_blocked_csc`` the pull kernel K1, on the others the
running sum of frontier hits over the CSC sources (K10,
``bitmask_gather_cumsum``) differenced at the CSC row bounds (kernels in
:mod:`gunrock_tpu_torch.ops.kernels`). Predecessors found in push levels
keep the JAX package's winner, the highest lane (the largest source in
the sorted frontier); those found in pull levels are filled after the
loop by :func:`_fill_preds`.

Non-DO BFS on a graph with ``has_pull2`` first takes the JAX package's
sweep route (``models/bfs.py:589-676``): unit-weight min-pull sweeps
(kernel K6, ``wmode="incr"``) to the fixpoint, labels from the
distances, predecessors from :func:`_fill_preds`; on the high-diameter
bail-out it falls back to the level-synchronous loop.
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
from ..ops.advance import expand
from ..ops.kernels import (bitmask_gather, bitmask_gather_cumsum,
                           last_hit_rows, pack_bitmask, pull_reached_words,
                           unpack_bitmask)
from ..ops.segment import (compact, dedup_winners, frontier_from_mask,
                           scatter_max, scatter_set)
from ..utils.info import make_info

__all__ = ["bfs", "BfsResult", "bfs_device"]

INVALID = -1
# Micro-loop rung width (the JAX package's DEEP_CAP).
DEEP_CAP = 8192
# Sort key of the lanes a micro round drops, past every vertex id.
_PAST = 0x7FFFFFF0


@dataclasses.dataclass
class BfsResult:
    labels: np.ndarray            # (V,) int32 depth, -1 unreachable
    preds: Optional[np.ndarray]   # (V,) int32 predecessor, -1 for src/unreached
    info: dict                    # reference Info JSON-style run record


@dataclasses.dataclass
class _State:
    # labels and preds are V-scale and updated IN PLACE by every level,
    # instead of being copied as the JAX package's functional updates are.
    labels: torch.Tensor              # (v_pad,) int32
    preds: Optional[torch.Tensor]     # (v_pad,) int32, None without preds
    frontier: Optional[torch.Tensor]  # int32 queue; None unless fvalid
    n: int                            # frontier length
    m_f: int                          # degree sum of the frontier
    fvalid: bool                      # frontier queue materialized
    use_pull: bool
    stats: LoopStats


def _count(mask: torch.Tensor, deg: torch.Tensor) -> tuple[int, int]:
    """(number of set lanes, degree sum over them), in one host read."""
    n, m_f = torch.stack([mask.sum(),
                          torch.where(mask, deg, 0).sum()]).tolist()
    host_read()
    return n, m_f


def _next_stats(graph: DeviceGraph, labels: torch.Tensor, depth: int,
                cap: int, is_new: torch.Tensor,
                dst: torch.Tensor) -> tuple[int, int]:
    """Next-frontier count and degree sum, counted as the JAX package
    counts them (``_dense_next_stats``): densely from the labels on rungs
    of at least ``v_pad // 8``, else over the new lanes (which counts a
    multi-edge's duplicate lanes twice)."""
    if cap >= graph.v_pad // 8:
        return _count(labels == depth, graph.out_degrees())
    d = dst.long()
    return _count(is_new, graph.row_offsets[d + 1] - graph.row_offsets[d])


def _unvisited(labels: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The push filter: which ``dst`` lanes are still unvisited.

    Routing rule: the JAX package sends only push rungs of at least 2^21
    lanes on a TPU through ``bitmask_gather`` and gathers labels
    directly elsewhere; here every push filter, the single-source fast
    path included, goes through the bitmask-gather kernel, whatever the
    size."""
    return bitmask_gather(pack_bitmask(labels == INVALID), dst) > 0


def _single_source_step(graph: DeviceGraph, cap: int, state: _State,
                        v: int, depth: int) -> int:
    """Fast path for a 1-vertex frontier: its CSR run is one contiguous
    slice, with no expansion or dedup. Leaves the queue unmaterialized.
    Returns the edge count (an overflow where it passes ``cap``)."""
    start, end = graph.row_offsets[v:v + 2].tolist()
    host_read()
    nbr = graph.col_indices[start:end]
    is_new = _unvisited(state.labels, nbr)
    scatter_set(state.labels, nbr, depth, mask=is_new)
    if state.preds is not None:
        scatter_set(state.preds, nbr, v, mask=is_new)
    state.n, state.m_f = _next_stats(graph, state.labels, depth, cap,
                                     is_new, nbr)
    state.frontier, state.fvalid = None, False
    return end - start


def _push_step(graph: DeviceGraph, caps: list, fcap: int, state: _State,
               depth: int, may_rebuild: bool) -> tuple[int, bool]:
    """One push level (``models/bfs.py:141-222``). Returns the edge count
    and whether the JAX package's queues of capacity ``fcap`` and rung
    ``cap`` would have overflowed (``:145,153,185,196``)."""
    if may_rebuild and not state.fvalid:
        # Lazy queue rebuild after levels that left it unmaterialized.
        frontier0, n0 = frontier_from_mask(state.labels == depth - 1)
    else:
        frontier0, n0 = state.frontier, state.n
    cap = ladder_rung(caps, max(state.m_f, state.n))
    if may_rebuild and n0 == 1:
        host_read()
        edges = _single_source_step(graph, cap, state, int(frontier0[0]),
                                    depth)
        return edges, edges > cap
    # The JAX package slices the queue to min(cap, fcap) lanes.
    overflow = n0 > min(cap, fcap)
    ex = expand(graph, torch.sort(frontier0).values)
    overflow = overflow or ex.total > cap
    is_new = _unvisited(state.labels, ex.dst)
    if may_rebuild and cap >= graph.v_pad // 4:
        # Big rung: duplicate dst lanes write the same depth, so no claim
        # dedup and no queue. The JAX package's preds are last-wins here;
        # amax over the sources picks the same (highest) lane, because
        # the sorted frontier orders the lanes by source.
        scatter_set(state.labels, ex.dst, depth, mask=is_new)
        if state.preds is not None:
            scatter_max(state.preds, ex.dst, ex.src, mask=is_new)
        state.n, state.m_f = _next_stats(graph, state.labels, depth, cap,
                                         is_new, ex.dst)
        state.frontier, state.fvalid = None, False
        return ex.total, overflow
    keep = dedup_winners(ex.dst, is_new, graph.v_pad)
    scatter_set(state.labels, ex.dst, depth, mask=keep)
    if state.preds is not None:
        scatter_set(state.preds, ex.dst, ex.src, mask=keep)
    state.frontier, state.n = compact(ex.dst, keep)
    d = state.frontier.long()
    state.m_f = int((graph.row_offsets[d + 1] - graph.row_offsets[d]).sum())
    host_read()
    state.fvalid = True
    return ex.total, overflow or state.n > fcap


def _micro_round(graph: DeviceGraph, state: _State, depth: int,
                 deg: torch.Tensor) -> int:
    """One round of the deep micro-loop (``models/bfs.py:272-305``) on
    the sorted queue: expand it, drop visited destinations, sort the rest
    stably by destination carrying the source, and keep the first lane of
    each run (the smallest source). The new queue is those destinations,
    ascending. Returns the edge count."""
    ex = expand(graph, state.frontier)
    is_new = state.labels[ex.dst.long()] == INVALID
    key_s, order = torch.sort(torch.where(is_new, ex.dst, _PAST),
                              stable=True)
    keep = key_s < _PAST
    keep[1:] &= key_s[1:] != key_s[:-1]
    new = key_s[keep]
    host_read()
    state.labels[new.long()] = depth
    if state.preds is not None:
        state.preds[new.long()] = ex.src[order][keep]
        host_read()
    state.frontier, state.n = new, new.shape[0]
    state.m_f = int(deg[new.long()].sum())
    host_read()
    return ex.total


def _deep_stretch(graph: DeviceGraph, state: _State, rung: int,
                  max_iters: int, deg: torch.Tensor, on_level) -> None:
    """Micro rounds while the queue and its edge volume fit ``rung``
    (``models/bfs.py:268-270,307-317``). The queue is rebuilt from the
    labels if a level left it unmaterialized, and sorted once; each
    round keeps it sorted. A micro round never overflows, but the
    stretch stops on an overflow, as the JAX package's does. ``on_level``
    is called after each round with the round's dispatch size."""
    if not state.fvalid:
        state.frontier, state.n = frontier_from_mask(
            state.labels == state.stats.iteration)
    state.frontier = torch.sort(state.frontier).values
    state.fvalid, state.use_pull = True, False
    state.stats.deep_stretches += 1
    while (0 < state.n <= rung and state.m_f <= rung
           and state.stats.iteration < max_iters
           and not state.stats.overflow):
        dispatch = max(state.m_f, state.n)
        with span("bfs.level", kind="micro"):
            edges = _micro_round(graph, state, state.stats.iteration + 1,
                                 deg)
            record_iteration(state.stats, frontier_len=state.n, edges=edges)
        on_level(dispatch)


def _pull_step(graph: DeviceGraph, state: _State, depth: int) -> int:
    """Full-edge pull over the CSC (``models/bfs.py:321-370``): v joins
    the frontier iff it is unvisited and some in-neighbor is in the
    current frontier. The frontier stays the label mask (no queue).

    With ``has_blocked_csc`` the reach words come from K1; without, from
    K10's running sum of hits over ``csc_indices``, sampled at the row
    bounds: v is reached iff its row's sum grew."""
    words = pack_bitmask(state.labels == depth - 1)
    if graph.has_blocked_csc:
        reached = unpack_bitmask(pull_reached_words(words, graph),
                                 graph.v_pad)
    else:
        run = bitmask_gather_cumsum(words, graph.csc_indices)
        # The sum before row bound b is run[b - 1], and 0 at b = 0. The
        # sums wrap modulo 2^32 past 2^31 hits (K10's int32 output), and
        # a row holds fewer than 2^32 hits, so its count is 0 iff its
        # two bounds' sums are equal, wrapped or not.
        off = graph.csc_offsets.long()
        samples = torch.where(off > 0, run[(off - 1).clamp(min=0)], 0)
        reached = samples[1:] != samples[:-1]
    new_mask = (state.labels == INVALID) & reached
    state.labels.masked_fill_(new_mask, depth)
    state.n, state.m_f = _count(new_mask, graph.out_degrees())
    state.frontier, state.fvalid = None, False
    return min(graph.num_edges, 2**31 - 1)


def _fill_preds(graph: DeviceGraph, labels: torch.Tensor,
                preds: torch.Tensor) -> torch.Tensor:
    """Post-hoc predecessors for vertices discovered in pull levels:
    pred(v) = the last in-neighbor (CSC order) with label(v) - 1
    (``models/bfs.py:373-386``). Updates ``preds`` in place, with no
    read to the host.

    The JAX package numbers the CSC slots with an int32 ``arange(e_pad)``
    and takes a ``cummax`` over all of them; here
    :func:`~gunrock_tpu_torch.ops.kernels.last_hit_rows` finds each row's
    last hit with int64 positions (kernel K14 on the card), so the fill
    stays exact past 2^31 edges and makes no edge-scale temporary."""
    with span("bfs.fill_preds"):
        last = last_hit_rows(graph, labels)
        ok = (labels > 0) & (preds == INVALID) & (last >= 0)
        preds.copy_(torch.where(ok, graph.csc_indices[last.clamp(min=0)],
                                preds))
    return preds


def _bfs_pull_sweeps(graph: DeviceGraph, src: int, *, mark_preds: bool,
                     max_iters: Optional[int]):
    """The sweep route (``models/bfs.py:589-640``): min-pull sweeps with
    ``incr`` from ``src`` in calls of ``GUNROCK_BFS_SWEEP_CHUNK`` (6) to
    the fixpoint. Returns ``(labels, preds, stats)``, or None on the
    bail-out (:func:`~gunrock_tpu_torch.enactor.sweep_to_fixpoint`)."""
    rounds = int(os.environ.get("GUNROCK_BFS_SWEEP_CHUNK", "6"))
    init = torch.full((graph.v_pad,), float("inf"), device=graph.device)
    init[src] = 0.0
    out = sweep_to_fixpoint(graph, init, wmode="incr", rounds=rounds,
                            budget=16384 if max_iters is None else max_iters)
    if out is None:
        return None
    dist, changed = out
    labels = torch.where(torch.isfinite(dist), dist,
                         float(INVALID)).to(torch.int32)
    preds = None
    if mark_preds:
        # The source is seeded as its own parent so that the fill skips
        # it, then reset, as in the JAX package.
        preds = torch.full_like(labels, INVALID)
        preds[src] = src
        _fill_preds(graph, labels, preds)
        preds[src] = INVALID
    stats = LoopStats(iteration=len(changed), nodes_queued=sum(changed),
                      edges_queued=graph.num_edges * len(changed),
                      frontier_trace=changed, route="pull_sweeps")
    return labels, preds, stats


def _phase(deep_on: bool, dispatch: int, direction_optimized: bool,
           pull: bool) -> str:
    """An instrument record's phase by the JAX package's rule
    (``models/bfs.py:707,721-727``): ``"deep"`` where the queue capacity
    holds the DEEP_CAP rung and the level's dispatch size fits it, unless
    a DO level pulled. The rule reads neither ``GUNROCK_BFS_DEEP`` nor the
    rungs, so with the micro-loop off such a push level is "deep" too."""
    if direction_optimized and pull:
        return "pull"
    return "deep" if deep_on and dispatch <= DEEP_CAP else "push"


def bfs_device(graph: DeviceGraph, src: int, *, mark_preds: bool = False,
               direction_optimized: bool = False, alpha: float = 15.0,
               beta: float = 18.0, queue_sizing: float = 1.0,
               max_iters: Optional[int] = None,
               instrument: Optional[list] = None):
    """BFS on an uploaded graph; returns ``(labels, preds, stats)`` with
    labels and preds as (v_pad,) tensors on the graph's device (preds is
    None without ``mark_preds``).

    ``queue_sizing`` scales the JAX package's queue capacity ``fcap``
    and its push rungs, which decide which micro-loop rungs exist, the
    ``"deep"`` label and where the JAX package's queues would overflow.
    The queues here are exact-size; a level that would have overflowed
    sets ``stats.overflow`` and ends the traversal there, as in the JAX
    package, and :func:`bfs` regrows ``queue_sizing``.

    ``instrument``: pass a list to collect one record per iteration (a
    micro round counts as one), ``{iteration, ms, frontier, phase,
    pull}``, as the JAX package's instrumented mode does; ``phase`` is
    ``"pull"``, ``"push"`` or ``"deep"`` by its rule (:func:`_phase`).

    Non-DO BFS on a graph with ``has_pull2`` takes the sweep route first
    unless ``instrument`` is given or ``GUNROCK_BFS_SWEEPS=0`` (see the
    module docstring); ``stats.route`` names the path taken."""
    if direction_optimized and not graph.has_csc:
        raise ValueError("direction_optimized BFS needs to_device(with_csc=True)")
    if not 0 <= src < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    route = "direction_optimized" if direction_optimized else "push"
    if (not direction_optimized and graph.has_pull2 and instrument is None
            and (not mark_preds or graph.has_csc)
            and os.environ.get("GUNROCK_BFS_SWEEPS", "1") == "1"):
        out = _bfs_pull_sweeps(graph, src, mark_preds=mark_preds,
                               max_iters=max_iters)
        if out is not None:
            return out
        route = "bailed_to_push"
    dev = graph.device
    if max_iters is None:
        max_iters = graph.num_nodes + 1
    base_cap = graph.v_pad // 4 if direction_optimized else graph.v_pad
    fcap = max(128, min(int(base_cap * queue_sizing), graph.v_pad))
    out_cap = max(128, min(int(graph.e_pad * min(queue_sizing, 1.0)),
                           graph.e_pad))
    caps = capacity_ladder(out_cap)
    rungs = []
    if os.environ.get("GUNROCK_BFS_DEEP", "1") == "1":
        rungs = [c for c in deep_rungs("GUNROCK_BFS_DEEP_RUNGS", DEEP_CAP)
                 if fcap >= c]
    deep_on = fcap >= DEEP_CAP
    deg = graph.out_degrees()
    labels = torch.full((graph.v_pad,), INVALID, dtype=torch.int32,
                        device=dev)
    labels[src] = 0
    preds = torch.full_like(labels, INVALID) if mark_preds else None
    start, end = graph.row_offsets[src:src + 2].tolist()
    host_read()
    state = _State(labels=labels, preds=preds,
                   frontier=torch.tensor([src], dtype=torch.int32,
                                         device=dev),
                   n=1, m_f=end - start, fvalid=True, use_pull=False,
                   stats=LoopStats(route=route))
    # The vote's constants, in float32 as the JAX package computes them.
    f32 = np.float32
    thresh_valid = f32(graph.num_edges / 32.0)
    thresh_lazy = f32(graph.num_edges / 4096.0)
    t0 = time.perf_counter()

    def on_level(dispatch: int) -> None:
        nonlocal t0
        if instrument is None:
            return
        sync(dev)
        t1 = time.perf_counter()
        instrument.append({
            "iteration": state.stats.iteration, "ms": (t1 - t0) * 1e3,
            "frontier": state.n,
            "phase": _phase(deep_on, dispatch, direction_optimized,
                            state.use_pull),
            "pull": state.use_pull})
        t0 = t1

    while (state.n > 0 and state.stats.iteration < max_iters
           and not state.stats.overflow):
        dispatch = max(state.m_f, state.n)
        if rungs and dispatch <= rungs[-1]:
            # The smallest rung that fits; the stretch spills back here
            # when the wavefront outgrows it.
            rung = next(c for c in rungs if dispatch <= c)
            _deep_stretch(graph, state, rung, max_iters, deg, on_level)
            continue
        with span("bfs.level") as level:
            depth = state.stats.iteration + 1
            use_pull, overflow = False, False
            if direction_optimized:
                thresh = thresh_valid if state.fvalid else thresh_lazy
                vote = f32(state.m_f) * f32(alpha) > thresh
                sticky = state.use_pull and (
                    f32(state.n) * f32(beta) > f32(graph.num_nodes))
                use_pull = bool(vote or sticky)
            if use_pull:
                level.set(kind="pull")
                edges = _pull_step(graph, state, depth)
            else:
                level.set(kind="push")
                edges, overflow = _push_step(graph, caps, fcap, state, depth,
                                             may_rebuild=direction_optimized)
            state.use_pull = use_pull
            record_iteration(state.stats, frontier_len=state.n, edges=edges,
                             overflow=overflow)
        on_level(dispatch)
    if mark_preds and direction_optimized:
        _fill_preds(graph, state.labels, state.preds)
    return state.labels, state.preds, state.stats


def bfs(graph: Union[CsrGraph, DeviceGraph], src: Union[int, str] = 0, *,
        mark_preds: bool = False, direction_optimized: bool = False,
        alpha: float = 15.0, beta: float = 18.0,
        queue_sizing: float = 1.0, max_iters: Optional[int] = None,
        idempotence: bool = False, instrumented: bool = False,
        device="cuda") -> BfsResult:
    """Run BFS from ``src`` and return host results + run record.

    API of :func:`gunrock_tpu.bfs` (reference ``gunrock_bfs``,
    ``gunrock/gunrock.h:173``) plus ``device``. A :class:`CsrGraph` is
    uploaded to ``device`` with the CSC and ``with_blocked_csc`` for DO,
    as the JAX package uploads it; a :class:`DeviceGraph` runs where it
    lies. ``queue_sizing`` sets the JAX package's queue capacity (see
    :func:`bfs_device`); while a run overflows it, the run is repeated
    with the sizing doubled, up to 4, and the per-iteration records
    cleared, as the JAX package regrows its queues (reference
    ``Check_Size``, ``enactor_helper.cuh:103``).
    ``idempotence`` is accepted for parity and has no effect: the claim
    filter is exact. ``instrumented`` collects per-iteration records into
    ``info["per_iteration"]``.

    Each call is the root span ``bfs``. Its run record holds the splits
    ``process_ms`` (the traversal), ``copy_ms`` (labels and preds to the
    host) and ``record_ms`` (the out-degree sum and search depth,
    reduced on the graph's device and read at once, and the run record;
    set after :func:`make_info` returns), and ``host_reads``, the
    traversal's blocking device-to-host reads
    (:data:`~gunrock_tpu_torch.enactor.COUNTS`).
    """
    del idempotence
    with span("bfs"):
        timer = Timer("bfs")
        per_iter: Optional[list] = [] if instrumented else None
        if isinstance(graph, CsrGraph):
            dev = resolve_device(device)
            if src == "largestdegree":
                src = graph.largest_degree_vertex()
            with timer.time("preprocess_ms"):
                dgraph = to_device(graph, with_csc=direction_optimized,
                                   with_blocked_csc=direction_optimized,
                                   device=dev)
                sync(dev)
        else:
            dgraph = graph
            dev = graph.device
        src = int(src)
        num_nodes = dgraph.num_nodes

        with timer.time("process_ms"):
            sizing = queue_sizing
            reads0 = COUNTS["host_reads"]
            while True:
                labels, preds, stats = bfs_device(
                    dgraph, src, mark_preds=mark_preds,
                    direction_optimized=direction_optimized, alpha=alpha,
                    beta=beta, queue_sizing=sizing, max_iters=max_iters,
                    instrument=per_iter)
                if not stats.overflow or sizing >= 4.0:
                    break
                sizing = min(sizing * 2.0, 4.0)
                if per_iter is not None:
                    per_iter.clear()
            host_reads = COUNTS["host_reads"] - reads0
            sync(dev)

        with timer.time("copy_ms"):
            labels_np = labels[:num_nodes].cpu().numpy()
            preds_np = preds[:num_nodes].cpu().numpy() if mark_preds else None
        with timer.time("record_ms"):
            # Edges visited = out-degree sum over reached vertices (the
            # reference's DOBFS accounting for m_teps, util/info.cuh:1431)
            # and the search depth, reduced where the labels lie and read
            # in one copy; an integral sum is int64, exact past 2^31.
            lab = labels[:num_nodes]
            deg = dgraph.out_degrees()[:num_nodes]
            edges_visited, search_depth = torch.stack([
                torch.where(lab >= 0, deg, 0).sum(),
                lab.max().clamp(min=0)]).tolist()
            info = make_info(
                primitive="bfs", graph=dgraph, stats=stats, timer=timer,
                edges_visited=edges_visited,
                extra={"src": src, "mark_predecessors": mark_preds,
                       "direction_optimized": direction_optimized,
                       "instrumented": instrumented,
                       "search_depth": search_depth,
                       "host_reads": host_reads,
                       **({"per_iteration": per_iter}
                          if instrumented else {})},
            )
        info["record_ms"] = timer.splits["record_ms"] * 1000.0
        return BfsResult(labels=labels_np, preds=preds_np, info=info)
