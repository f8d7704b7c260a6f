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

Tracing. :func:`span` marks a stretch of host work by name. Spans are
recorded only inside :func:`tracing`, each as ``(id, parent, query,
name, start_ns, end_ns, attrs)`` on ``time.time_ns()``, the clock that
``torch.profiler`` stamps its events with, so that a profile of the
device can be read by them; ``query`` is the id of the outermost open
span (each public call's root span). Outside :func:`tracing`,
:func:`span` hands out one shared no-op context: a call and a branch,
no clock read and no record. The tracer never waits for the device.
The splits of a :class:`Timer` named by its primitive (``bfs()``'s) are
spans too. Always on, and process-wide: :data:`COUNTS` (the host loops'
blocking device-to-host reads, :func:`host_read`, and the levels and
edges :func:`record_iteration` counts) and :data:`SPLITS` (the calls and
seconds of every named :class:`Timer`'s splits by span name).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from typing import Optional

__all__ = ["LoopStats", "record_iteration", "capacity_ladder", "ladder_rung",
           "deep_rungs", "sweep_to_fixpoint", "Timer", "span", "tracing",
           "host_read", "COUNTS", "SPLITS"]

# Process-wide counts since import: "host_reads", the blocking
# device-to-host reads of the host loops (a ``.tolist()``, an ``int()``
# of a device value, a ``nonzero`` size, a boolean-mask index or
# assignment), "levels", the iterations record_iteration counted, and
# "edges", their edges (the edges an SSSP round relaxes; a full pull
# round counts every edge).
COUNTS = {"host_reads": 0, "levels": 0, "edges": 0}
# Every split of a named Timer since import by span name: [calls,
# seconds].
SPLITS: dict[str, list] = {}

# The open trace's records, None while tracing is off; the open spans,
# innermost last.
_TRACE: Optional[list] = None
_OPEN: list = []
_IDS = itertools.count(1)


def host_read(n: int = 1) -> None:
    """Count ``n`` blocking device-to-host reads in :data:`COUNTS`."""
    COUNTS["host_reads"] += n


class _NoSpan:
    """The one span :func:`span` hands out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "query", "start", "trace")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name, self.attrs, self.trace = name, attrs, _TRACE

    def __enter__(self):
        self.id = next(_IDS)
        outer = _OPEN[-1] if _OPEN else None
        self.parent = outer.id if outer else None
        self.query = outer.query if outer else self.id
        _OPEN.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if _OPEN and _OPEN[-1] is self:
            _OPEN.pop()
        # A span still open when its trace closed is dropped.
        if self.trace is _TRACE:
            self.trace.append((self.id, self.parent, self.query, self.name,
                               self.start, end, self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only after the span opened."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context that records ``name`` with ``attrs`` from its entry to
    its exit while :func:`tracing` is open; the shared no-op otherwise.
    Either has ``set(**attrs)``."""
    if _TRACE is None:
        return _NO_SPAN
    return _Span(name, attrs)


@contextlib.contextmanager
def tracing():
    """Record every span opened inside the block; yields the list of
    records, complete when the block ends. Not reentrant."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("tracing() is already open")
    _TRACE = records = []
    try:
        yield records
    finally:
        _TRACE = None
        _OPEN.clear()


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
    COUNTS["levels"] += 1
    COUNTS["edges"] += edges
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
        host_read()
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
    Callers fence device work themselves before a split ends. Given a
    ``primitive``, a split ``<name>_ms`` is also the span
    ``<primitive>.<name>`` and adds to :data:`SPLITS`; without one it is
    only timed."""

    def __init__(self, primitive: str = "") -> None:
        self.splits: dict[str, float] = {}
        self.primitive = primitive

    @contextlib.contextmanager
    def time(self, name: str):
        label = f"{self.primitive}.{name.removesuffix('_ms')}"
        with span(label) if self.primitive else _NO_SPAN:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.splits[name] = self.splits.get(name, 0.0) + dt
                if self.primitive:
                    total = SPLITS.setdefault(label, [0, 0.0])
                    total[0] += 1
                    total[1] += dt
