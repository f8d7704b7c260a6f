"""The program's own spans and counters, and the device profile read by
them.

The port records named spans of its host work inside its ``tracing()``
block (``gunrock_tpu_torch.enactor``), each ``(id, parent, query, name,
start_ns, end_ns, attrs)`` on ``time.time_ns()``, the clock that
``torch.profiler`` stamps its events with. A public ``bfs()`` call is
the root span ``bfs``; under it ``bfs.process`` (the traversal, the
interval of ``info["process_ms"]``), a ``bfs.level`` a level with
``kind`` ``push``, ``pull`` or ``micro``, ``bfs.fill_preds``, then
``bfs.copy`` and ``bfs.record``. Always on, it keeps process-wide counts
(``COUNTS``: the host loops' blocking device-to-host reads and the
levels) and the calls and seconds of each timed split (``SPLITS``, by
span name).

:func:`profile_spans` takes one device-only stretch of whole queries as
``trace.profile_queries`` takes its first, with the same sentinels,
optionally under the port's ``tracing()``, and returns a
:class:`SpanTrace`: the ``trace.Trace`` of the stretch, the program's
spans on the profiler's clock in microseconds, each device interval's
launch on the host (matched by the kineto correlation id of its runtime
call) and the host's blocking calls. The readers of
``metrics/loop_idle_ms_per_level.py`` and
``metrics/pred_fill_device_ms_per_query.py`` and :func:`idle_by_kind`
read it; the harness's own trace has none of it, so they return None
there.

The program is reached only by the dotted names below, through
``harness.resolve``; a program without them reads as None.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Optional

import torch

from . import harness
from . import trace as tracing

TRACING = "gunrock_tpu_torch.enactor.tracing"
COUNTS = "gunrock_tpu_torch.enactor.COUNTS"
SPLITS = "gunrock_tpu_torch.enactor.SPLITS"
# The runtime calls that launch a kernel.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def program(dotted: str):
    """The program's object at ``dotted``, or None where it has none."""
    try:
        return harness.resolve(dotted)
    except (ImportError, AttributeError):
        return None


def entry_prefix(run) -> str:
    """The span prefix of the cell's entry: ``bfs`` for
    ``gunrock_tpu_torch.bfs``."""
    return run.traffic["entry"]["call"].rsplit(".", 1)[-1]


def split_mean_ms(name: str) -> Optional[float]:
    """The mean of the program's timed split ``name`` over every call
    of the process, in ms, or None where it kept none."""
    splits = program(SPLITS)
    calls, seconds = (splits or {}).get(name, (0, 0.0))
    return seconds * 1e3 / calls if calls else None


@dataclasses.dataclass
class SpanTrace(tracing.Trace):
    """A ``trace.Trace`` with the program's spans (``(id, parent,
    query, name, start_us, end_us, attrs)``), ``launch_us[i]`` the host
    time of ``device[i]``'s runtime call (None where unmatched),
    ``syncs_us`` the start of each of the host's ``trace.HOST_SYNCS``
    calls in the stretch, and ``wall_s`` the host's wall from the first
    query's call to the last one's return and the device's drain."""
    spans: list = dataclasses.field(default_factory=list)
    launch_us: list = dataclasses.field(default_factory=list)
    syncs_us: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0


def _kineto(prof):
    """(name, is_device, start_us, end_us, is_annotation, correlation)
    of every event."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns() / 1e3, e.is_user_annotation(),
               e.correlation_id())


def span_trace(evs: list, records: list, queries: int,
               wall_s: float) -> Optional[SpanTrace]:
    """The :class:`SpanTrace` of a device-only profile's events ``evs``
    (as :func:`_kineto` gives them) and the program's ``records``, or
    None where its sentinels were lost."""
    plain = [ev[:5] for ev in evs]
    window = tracing._window_of_markers(plain)
    got = window and tracing._device_trace(plain, queries, *window)
    if not got:
        return None
    lo, hi = window
    # The same intervals, in the same order, as _device_trace keeps.
    corr = [c for n, dev, s, e, ann, c in evs
            if dev and not ann and not n.startswith("gbench.")
            and tracing.SENTINEL not in n and s < hi and e > lo]
    host = {c: s for n, dev, s, _, _, c in evs
            if not dev and tracing._is_runtime(n)}
    base = {f.name: getattr(got, f.name)
            for f in dataclasses.fields(tracing.Trace)}
    return SpanTrace(
        **base,
        spans=[(i, p, q, n, s / 1e3, e / 1e3, a)
               for i, p, q, n, s, e, a in records],
        launch_us=[host.get(c) for c in corr],
        syncs_us=sorted(s for n, dev, s, _, _, _ in evs
                        if not dev and n in tracing.HOST_SYNCS
                        and lo <= s <= hi),
        wall_s=wall_s)


def profile_spans(query: Callable[[], None], queries: int,
                  device: torch.device, traced: bool = True) -> SpanTrace:
    """``queries`` calls of ``query`` in one device-only profile, between
    a lead of sentinels and a tail marker, under the program's
    ``tracing()`` where ``traced`` (and where the program has it).
    Raises where no whole profile came in ``trace.ATTEMPTS``."""
    from torch.profiler import ProfilerActivity, profile
    opener = program(TRACING) if traced else None
    lead = tracing.LEAD
    for _ in range(tracing.ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tracing._lead(lead)
            with (opener() if opener else contextlib.nullcontext([])) \
                    as records:
                t0 = time.perf_counter()
                for _ in range(queries):
                    query()
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
            torch.cuda._sleep(tracing.SENTINEL_CYCLES)
            torch.cuda.synchronize(device)
        got = span_trace(list(_kineto(prof)), records, queries, wall)
        if got is not None:
            return got
        lead *= 4
    raise RuntimeError(f"torch.profiler gave no whole profile of {queries} "
                       f"queries in {tracing.ATTEMPTS} tries")


def _named(t: SpanTrace, name: str) -> list:
    return [sp for sp in t.spans if sp[3] == name]


def _overlap(gaps: list, lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in gaps)


def idle_gaps(t: SpanTrace) -> list:
    """The device's idle gaps over the stretch."""
    return tracing._union([(s, e) for _, s, e in t.device], *t.window)[1]


def loop_idle_ms_per_level(t: SpanTrace, prefix: str = "bfs"
                           ) -> Optional[float]:
    """Device idle inside the ``<prefix>.process`` spans less that inside
    their ``<prefix>.fill_preds`` spans, in ms, over the number of
    ``<prefix>.level`` spans; None without a level."""
    levels = len(_named(t, f"{prefix}.level"))
    if not levels:
        return None
    gaps = idle_gaps(t)
    idle = sum(_overlap(gaps, sp[4], sp[5])
               for sp in _named(t, f"{prefix}.process"))
    idle -= sum(_overlap(gaps, sp[4], sp[5])
                for sp in _named(t, f"{prefix}.fill_preds"))
    return idle / 1e3 / levels


def _inside(at: Optional[float], spans: list) -> bool:
    return at is not None and any(sp[4] <= at <= sp[5] for sp in spans)


def device_ms_launched_in(t: SpanTrace, name: str) -> Optional[float]:
    """Device time of the kernels (copies and fills left out) whose
    launch lies inside a span ``name``, in ms per query; None where the
    trace holds no such span."""
    spans = _named(t, name)
    if not spans:
        return None
    us = sum(e - s for (n, s, e), at in zip(t.device, t.launch_us)
             if not tracing.is_copy_or_fill(n) and _inside(at, spans))
    return us / 1e3 / t.queries


def idle_by_kind(t: SpanTrace, prefix: str = "bfs") -> dict:
    """The stretch's device idle in ms per query by the innermost
    program span open over it: the level kinds (``push``, ``pull``,
    ``micro``), ``fill_preds``, the rest of ``process``, ``copy``,
    ``record``, the rest of the call (``entry``), and ``outside`` any
    call."""
    names = {f"{prefix}.process": "process_rest",
             f"{prefix}.fill_preds": "fill_preds", f"{prefix}.copy": "copy",
             f"{prefix}.record": "record", prefix: "entry"}
    host = []
    for _, _, _, name, s, e, attrs in t.spans:
        if name == f"{prefix}.level":
            host.append((attrs.get("kind", "level"), s, e))
        elif name in names:
            host.append((names[name], s, e))
    out = collections.Counter(tracing._label_gaps(idle_gaps(t), host))
    out["outside"] = out.pop("(no host event)", 0.0)
    return {k: v / 1e3 / t.queries for k, v in sorted(out.items())}


def syncs_inside(t: SpanTrace, name: str) -> int:
    """The host's blocking calls inside the spans ``name``."""
    spans = _named(t, name)
    return sum(1 for at in t.syncs_us if _inside(at, spans))


def launched_inside_share(t: SpanTrace, name: str) -> Optional[float]:
    """The share of the stretch's kernels whose launch lies inside a
    span ``name``: 1.0 where the program's clock and the profiler's
    agree and every kernel is the program's."""
    spans = _named(t, name)
    at = [a for (n, _, _), a in zip(t.device, t.launch_us)
          if not tracing.is_copy_or_fill(n)]
    if not spans or not at:
        return None
    return sum(1 for a in at if _inside(a, spans)) / len(at)
