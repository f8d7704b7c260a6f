"""Enactor: loop statistics, the capacity ladder, the micro-loop rungs,
the min-pull sweep loop and the run timer.

Counterpart of :mod:`gunrock_tpu.enactor`. The JAX package compiles the
superstep loop into one ``lax.while_loop`` and keeps its statistics on
the device; here the loop runs on the host (PyTorch is eager), so the
statistics (reference ``EnactorStats``, ``enactor_types.cuh:50-194``) are
plain Python numbers. The port's tensors are exact-size, so nothing
dispatches by capacity; :func:`capacity_ladder` stays as host arithmetic
because the JAX package's choices of push rung (and with them the
direction vote's inputs) are defined by it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

__all__ = ["LoopStats", "record_iteration", "capacity_ladder", "ladder_rung",
           "deep_rungs", "sweep_to_fixpoint", "Timer"]


@dataclasses.dataclass
class LoopStats:
    """Running statistics of a traversal (reference EnactorStats:
    ``iteration``, ``nodes_queued``/``edges_queued`` accumulators,
    ``enactor_types.cuh:50-80``) and the per-iteration frontier sizes
    (``util/info.cuh:684-709``). Exact-size tensors cannot overflow, so
    ``overflow`` records a capacity the JAX package's rule would have
    exceeded (BFS's and SSSP's ``queue_sizing``); it stops the loop. ``route``
    names the path a primitive took where it has several (the min-pull
    sweeps, the push loop after their bail-out), for the Info record.
    ``deep_stretches`` counts the BFS deep micro-loop's stretches."""

    iteration: int = 0
    nodes_queued: float = 0.0
    edges_queued: float = 0.0
    overflow: bool = False
    frontier_trace: list = dataclasses.field(default_factory=list)
    route: str = ""
    deep_stretches: int = 0


def record_iteration(stats: LoopStats, *, frontier_len: int,
                     edges: int, overflow: bool = False) -> None:
    """Account one finished iteration (in place)."""
    stats.iteration += 1
    stats.nodes_queued += frontier_len
    stats.edges_queued += edges
    stats.overflow = stats.overflow or overflow
    stats.frontier_trace.append(int(frontier_len))


def capacity_ladder(max_cap: int, *, base: int = 4096,
                    step: int = 8) -> list[int]:
    """Geometric ladder of advance-output capacities up to ``max_cap``,
    as the JAX package builds it (the analogue of the reference's
    RelaxLightEdges vs RelaxPartitionedEdges2 dispatch by frontier size,
    ``oprtr/edge_map_partitioned/kernel.cuh:185,355``)."""
    caps: list[int] = []
    c = base
    while c < max_cap:
        caps.append(c)
        c *= step
    caps.append(max_cap)
    return caps


def ladder_rung(caps: list[int], size: int) -> int:
    """The rung the JAX package dispatches ``size`` to: the smallest cap
    at least ``size``, else the last (``dispatch_by_size``)."""
    for c in caps[:-1]:
        if size <= c:
            return c
    return caps[-1]


def deep_rungs(env: str, default: int) -> tuple:
    """Micro-loop rung widths from a comma list in the environment
    variable ``env`` (ascending, deduplicated), else ``(default,)``: the
    JAX package's ``_deep_rungs`` (``models/bfs.py:233-244``)."""
    raw = os.environ.get(env, "")
    if not raw:
        return (default,)
    return tuple(sorted({int(x) for x in raw.split(",") if x}))


def sweep_to_fixpoint(graph, init, *, wmode: str, rounds: int,
                      budget: int, instrument: Optional[list] = None):
    """The JAX package's sweep loop (``models/sssp.py:663-706``,
    ``models/bfs.py:589-622``): calls of ``rounds`` min-pull sweeps
    (kernel K6 on CUDA), one host read of the change counts a call, until
    an even sweep changes nothing or ``budget`` sweeps ran. Returns
    ``(dist, changed)``, the per-sweep counts as a list, or None on the
    high-diameter bail-out: a call ends unconverged after fewer than
    ``GUNROCK_SWEEP_BAIL_FRAC`` (0.05) of the vertices changed in all, or
    after ``GUNROCK_SWEEP_BAIL`` (48) sweeps. ``instrument`` gets one
    record a call, phase ``"pull_sweeps"``."""
    from .ops.pull2 import pull_min_sweeps
    bail_total = int(os.environ.get("GUNROCK_SWEEP_BAIL", "48"))
    bail_frac = float(os.environ.get("GUNROCK_SWEEP_BAIL_FRAC", "0.05"))
    dist, changed, total = init, [], 0
    t0 = time.perf_counter()
    while True:
        dist, chg = pull_min_sweeps(graph, dist, sweeps=rounds, wmode=wmode)
        chg = chg.tolist()
        changed.extend(chg)
        total += rounds
        if instrument is not None:
            t1 = time.perf_counter()
            instrument.append({"iteration": total, "ms": (t1 - t0) * 1e3,
                               "frontier": chg[-1], "phase": "pull_sweeps"})
            t0 = t1
        if any(c == 0 for c in chg[0::2]) or total >= budget:
            return dist, changed
        if sum(changed) < bail_frac * graph.num_nodes or total >= bail_total:
            return None


class Timer:
    """Wall-clock timing split matching the reference's Info record
    (load / preprocess / process / postprocess, ``util/info.cuh``).
    Callers fence device work themselves before a split ends."""

    def __init__(self) -> None:
        self.splits: dict[str, float] = {}

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.splits[name] = timer.splits.get(name, 0.0) + (
                    time.perf_counter() - self.t0)

        return _Ctx()
