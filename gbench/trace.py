"""A traced stretch of whole queries and what the per-layer readers take
from it.

``profile_queries`` keeps a summary of ``torch.profiler``'s records,
never the chrome trace: every device interval (kernels, copies, fills)
of a stretch of whole queries, the count of each CUDA runtime call made
in it, the device's busy time (the union of its intervals) over the
stretch's wall, and the idle gaps of a second, shorter stretch labelled
by what the host was doing. The first stretch records device activity
alone, which costs the host little; the second records the host's
operators too, inside a ``gbench.window`` span with one ``gbench.query``
span a query and the benchmark's own spans around the program's
functions (``wrap``).

The profiler can lose the first device events of a window late in a
process. As in the port's ``tools/profile_value.py`` (``profile_run``,
whose arithmetic this copies: device events summed over the profiled
wall, on one stream), each profile opens with sentinel kernels
(``torch.cuda._sleep``) and counts only where a sentinel survived; it
is taken again with four times as many sentinels otherwise, and the
run fails after :data:`ATTEMPTS`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import heapq
import importlib
from typing import Callable, Iterable

import torch

WINDOW, QUERY, SPAN = "gbench.window", "gbench.query", "gbench.span:"
# From tools/profile_value.py: the sentinel kernel's name, its cycles,
# how many open a profile at first, and how many profiles are taken.
SENTINEL, SENTINEL_CYCLES = "spin_kernel", 5000
LEAD, ATTEMPTS = 64, 5
# CUDA runtime calls after which the host has waited for the device: a
# device-to-host copy in PyTorch is cudaMemcpyAsync then
# cudaStreamSynchronize, so the copies are counted by their syncs.
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
NAME_CHARS = 120
# Every __global__ kernel of gunrock_tpu_torch/csrc/ (K1-K10 and their
# prologues and finishes), as the device trace names them.
PROGRAM_KERNELS = (
    "bitmask_gather_kernel", "brandes_finish_kernel", "brandes_gate_kernel",
    "csc_tile_rows_kernel", "fold_per_source_kernel", "gated_finish_kernel",
    "gated_tiles_kernel", "gather_cumsum_kernel", "power_finish_kernel",
    "pull_finish_kernel", "pull_reached_words_kernel", "pull_tiles_kernel",
    "reduce_tiles_kernel", "sample_sorted_kernel", "scatter_sorted_kernel",
    "seed_groups_kernel")


@dataclasses.dataclass
class Trace:
    """What a traced stretch of ``queries`` whole queries left.

    Times are in microseconds on the profiler's clock; ``device`` holds
    (name, start, end) of every device interval inside the stretch."""
    queries: int
    window: tuple[float, float]
    device: list[tuple[str, float, float]]
    runtime: collections.Counter
    busy_us: float
    idle_by_host: list[tuple[str, float]]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_us(self, keep: Callable[[str], bool]) -> float:
        """Summed device time of the intervals whose name ``keep``s."""
        return sum(e - s for n, s, e in self.device if keep(n))

    def device_count(self, keep: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.device if keep(n))

    def program_launches(self) -> dict:
        """Launches of each of the program's own kernels in the stretch."""
        out = {k: self.device_count(lambda n, k=k: k in n)
               for k in PROGRAM_KERNELS}
        return {k: c for k, c in out.items() if c}

    def top_device_ops(self, k: int = 10) -> list[tuple[str, float]]:
        """The ``k`` device operations that took most time, in seconds."""
        by_name: collections.Counter = collections.Counter()
        for n, s, e in self.device:
            by_name[n[:NAME_CHARS]] += (e - s) / 1e6
        return [[n, t] for n, t in by_name.most_common(k)]


def is_copy_or_fill(name: str) -> bool:
    """Device copies and fills, as CUPTI names them."""
    return name.startswith(("Memcpy", "Memset"))


def _is_runtime(name: str) -> bool:
    """CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _events(prof):
    """(name, is_device, start_us, end_us, is_annotation) of every
    event, from the profiler's raw records (faster to read than its
    event tree)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns() / 1e3, e.is_user_annotation())


def _union(intervals: list[tuple[float, float]], lo: float, hi: float):
    """Busy time of the merged ``intervals`` clipped to [lo, hi], and
    the gaps between them there."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _label_gaps(gaps, host) -> collections.Counter:
    """Idle time by what the host was doing: each stretch of a gap goes
    to the innermost host event open over it (the shortest of those
    that began before it and end after it). A sweep over the host
    events' and gaps' bounds in time order, with a heap of the open
    events, shortest first (an event that has ended by one point has
    ended by every later one)."""
    host = sorted(host, key=lambda h: h[1])
    points = sorted({t for _, s, e in host for t in (s, e)}
                    | {t for g in gaps for t in g})
    out: collections.Counter = collections.Counter()
    heap: list = []
    i = g = 0
    gaps = sorted(gaps)
    for t0, t1 in zip(points, points[1:]):
        while g < len(gaps) and gaps[g][1] <= t0:
            g += 1
        if g == len(gaps):
            break
        if t1 <= gaps[g][0]:
            continue
        while i < len(host) and host[i][1] <= t0:
            name, s, e = host[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < t1:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "(no host event)"
        out[label[:NAME_CHARS]] += t1 - t0
    return out


def _window_of_markers(evs):
    """(lo, hi) of a device profile: from the end of the last lead
    sentinel to the start of the tail marker, both ``spin_kernel``s on
    the device, or None where the sentinels or the marker were lost."""
    spins = sorted((s, e) for n, dev, s, e, _ in evs if dev and SENTINEL in n)
    if len(spins) < 2:
        return None
    return max(e for _, e in spins[:-1]), spins[-1][0]


def _device_trace(evs, queries: int, lo: float, hi: float):
    device = [(n, s, e) for n, dev, s, e, ann in evs
              if dev and not ann and not n.startswith("gbench.")
              and SENTINEL not in n and s < hi and e > lo]
    if not device:
        return None
    calls = sorted((s, n) for n, dev, s, _, _ in evs
                   if not dev and _is_runtime(n) and lo <= s <= hi)
    runtime = collections.Counter(n for _, n in calls)
    # The benchmark's own calls at the close: its synchronize and the
    # tail marker's launch.
    for own in ("cudaDeviceSynchronize", "cudaLaunchKernel"):
        if runtime[own]:
            runtime[own] -= 1
    busy, _ = _union([(s, e) for _, s, e in device], lo, hi)
    return Trace(queries=queries, window=(lo, hi), device=device,
                 runtime=runtime, busy_us=busy, idle_by_host=[])


def _host_labels(evs):
    """Idle time by host event over the ``gbench.window`` span of a
    profile with CPU activity, or None where the span is missing."""
    windows = [(s, e) for n, dev, s, e, _ in evs if n == WINDOW and not dev]
    if not windows:
        return None
    lo, hi = windows[0]
    device = [(s, e) for n, dev, s, e, ann in evs
              if dev and not ann and not n.startswith("gbench.")
              and SENTINEL not in n and s < hi and e > lo]
    _, gaps = _union(device, lo, hi)
    host = [(n, s, e) for n, dev, s, e, _ in evs
            if not dev and not _is_runtime(n) and s < hi and e > lo]
    idle = _label_gaps(gaps, host)
    return [[n, t / 1e6] for n, t in idle.most_common(10)]


def _spanned(fn, label: str):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def spans(names: Iterable[str]):
    """Wrap each ``module.attr`` in ``names`` in a profiler span named
    after it while the block runs, and put the originals back after. A
    name the program no longer has is skipped."""
    undo = []
    try:
        for dotted in names:
            mod_name, attr = dotted.rsplit(".", 1)
            try:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
            except (ImportError, AttributeError):
                continue
            setattr(mod, attr, _spanned(fn, SPAN + dotted))
            undo.append((mod, attr, fn))
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def _lead(lead: int) -> None:
    for _ in range(lead):
        torch.cuda._sleep(SENTINEL_CYCLES)
    torch.cuda.synchronize()


def profile_queries(query: Callable[[], None], queries: int,
                    device: torch.device, wrap: Iterable[str] = (),
                    label_queries: int = 1) -> Trace:
    """Profile ``queries`` calls of ``query`` in one stretch, with device
    activity alone (the CUDA runtime calls and the device's intervals),
    so that the host pays little for the profile; then ``label_queries``
    more with the host's operators and the benchmark's spans around
    ``wrap`` recorded, which name what the host did in the device's idle
    gaps (that profile slows the host, so its gaps are longer than the
    first's). The first profile's window runs from the last lead
    sentinel's end to a tail marker's start on the device. Raises where
    no whole profile came. On the CPU only the second profile is taken,
    and the trace holds no device interval."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = device.type == "cuda"
    got = None
    lead = LEAD
    for _ in range(ATTEMPTS if cuda else 0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead(lead)
            for _ in range(queries):
                query()
            torch.cuda.synchronize(device)
            torch.cuda._sleep(SENTINEL_CYCLES)
            torch.cuda.synchronize(device)
        evs = list(_events(prof))
        window = _window_of_markers(evs)
        got = window and _device_trace(evs, queries, *window)
        if got is not None:
            break
        lead *= 4
    if cuda and got is None:
        raise RuntimeError(f"torch.profiler gave no whole profile of "
                           f"{queries} queries in {ATTEMPTS} tries")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    labels = None
    lead = LEAD if cuda else 0
    for _ in range(ATTEMPTS):
        with spans(wrap), profile(activities=acts) as prof:
            if cuda:
                _lead(lead)
            with record_function(WINDOW):
                for _ in range(label_queries):
                    with record_function(QUERY):
                        query()
                if cuda:
                    torch.cuda.synchronize(device)
        labels = _host_labels(list(_events(prof)))
        if labels is not None:
            break
        lead *= 4
    if got is None:
        got = Trace(queries=queries, window=(0.0, 0.0), device=[],
                    runtime=collections.Counter(), busy_us=0.0,
                    idle_by_host=[])
    got.idle_by_host = labels or []
    return got
