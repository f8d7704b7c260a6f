"""Enactor: loop statistics, the capacity ladder and the run timer.

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
import time

__all__ = ["LoopStats", "record_iteration", "capacity_ladder", "ladder_rung",
           "Timer"]


@dataclasses.dataclass
class LoopStats:
    """Running statistics of a traversal (reference EnactorStats:
    ``iteration``, ``nodes_queued``/``edges_queued`` accumulators,
    ``enactor_types.cuh:50-80``) and the per-iteration frontier sizes
    (``util/info.cuh:684-709``). Exact-size tensors cannot overflow, so
    ``overflow`` stays False; it is kept for the Info record."""

    iteration: int = 0
    nodes_queued: float = 0.0
    edges_queued: float = 0.0
    overflow: bool = False
    frontier_trace: list = dataclasses.field(default_factory=list)


def record_iteration(stats: LoopStats, *, frontier_len: int,
                     edges: int) -> None:
    """Account one finished iteration (in place)."""
    stats.iteration += 1
    stats.nodes_queued += frontier_len
    stats.edges_queued += edges
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
