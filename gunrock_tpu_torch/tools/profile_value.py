"""Device profile of the value primitives: where a PageRank or HITS run
spends its time on the card.

    python -m gunrock_tpu_torch.tools.profile_value [--scale 20]
        [--edge-factor 32] [--runs 3] [--device cuda]

Builds R-MAT (``--scale``, ``--edge-factor``, seed 1, undirected), the
graph of ``chip_smoke.py``, uploads it ``with_csc``, ``with_edge_src``
and ``with_blocked_values``, and for each of

  * the PageRank power route (20 iterations at threshold 0, kernel K4),
  * the PageRank loop route (the same, with ``instrument``; kernel K3),
  * HITS (10 iterations, kernel K3 over the graph and its reverse),
  * WTF from the largest-degree vertex at its defaults (50 PPR
    iterations through K3 with a host read each, the CoT's expand and
    SALSA's scatters),

runs it once to warm up, then ``--runs`` times under ``torch.profiler``
and prints:

  * ``wall``: host time a run, fenced with a device synchronize
    (the profiler's own overhead included);
  * ``device``: the summed duration of every event the profiler records
    on the device (kernels, copies, fills), a run. Everything runs on one
    stream, so those events do not overlap;
  * ``busy``: device / wall, the share of the run the card was working;
  * each device event's name, calls a run and ms a run, largest first.

The unprofiled times are ``chip_smoke.py`` phases 10 and 25. Where the profiler
records no device events, device and busy print as "not measured".
"""

from __future__ import annotations

import argparse
import collections
import time

import torch

from ..graph.device import sync, to_device
from ..io import rmat
from ..models.hits import hits_device
from ..models.pr import pagerank_device
from ..models.wtf import wtf_device

PR_ITERS, HITS_ITERS = 20, 10
WTF_ITERS = 50  # wtf_device's max_iters, which PPR reaches on R-MAT
# profile_run: the sentinel kernels that open a window (torch.cuda._sleep,
# whose kernel is named so, each a few microseconds), how many at first,
# and the profiles it takes, with four times as many each time, before it
# gives up on a whole one.
SENTINEL, SENTINEL_CYCLES = "spin_kernel", 5000
LEAD, ATTEMPTS = 64, 5


def _profile_once(fn, runs: int, device: torch.device, lead: int) -> dict:
    """One profile of ``runs`` calls of ``fn``, after ``lead`` short
    sentinel kernels (``torch.cuda._sleep``) that are left out of the
    result: where the profiler loses the first device events of its
    window, it loses those. ``whole``: the profile holds a sentinel, at
    least one device event a call and a multiple of ``runs`` of each
    kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(lead):
            torch.cuda._sleep(SENTINEL_CYCLES)
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    per_name = collections.defaultdict(lambda: [0, 0.0])
    sentinels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if SENTINEL in evt.name:
            sentinels += 1
            continue
        row = per_name[evt.name]
        row[0] += 1
        row[1] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(ms for _, ms in per_name.values()) / runs
    counts = [c for c, _ in per_name.values()]
    whole = (sentinels > 0 or lead == 0) and sum(counts) >= runs and all(
        c % runs == 0 for c in counts)
    return {"wall_ms": wall_ms, "device_ms": device_ms, "whole": whole,
            "events": sorted(((name, calls / runs, ms / runs)
                              for name, (calls, ms) in per_name.items()),
                             key=lambda r: -r[2])}


def profile_run(fn, runs: int, device: torch.device) -> dict:
    """Profile ``runs`` calls of ``fn`` after one warm-up call.

    On the H100 the profiler can lose the first device events of a
    window, more of them the older the process, while the host still
    records every launch (a ``chip_smoke.py`` run kept 7 of K8's 20). So each window opens with :data:`LEAD` sentinel kernels, left
    out of the result, and a profile counts only where a sentinel
    survived (the loss ended before the calls) and each kernel name came
    a whole number of times a call; otherwise it is taken again with
    four times the sentinels, up to :data:`ATTEMPTS` times, and then this
    raises. On the CPU there are no device events to lose."""
    fn()
    sync(device)
    if device.type != "cuda":
        return _profile_once(fn, runs, device, 0)
    lead = LEAD
    for _ in range(ATTEMPTS):
        r = _profile_once(fn, runs, device, lead)
        if r["whole"]:
            return r
        lead *= 4
    counts = {name: calls for name, calls, _ in r["events"]}
    raise RuntimeError(f"torch.profiler lost device events in {ATTEMPTS} "
                       f"profiles of {runs} calls; the last held {counts} "
                       "a call")


def print_profile(name: str, label: str, r: dict, top=None) -> None:
    """Print one :func:`profile_run` result: wall, device and busy share
    a run, then its ``top`` largest device events (all when None)."""
    if r["device_ms"] > 0:
        device = (f"device {r['device_ms']:.4f} ms, busy "
                  f"{100.0 * r['device_ms'] / r['wall_ms']:.1f}%")
    else:
        device = "device not measured, busy not measured"
    print(f"[{name}] {label}: wall {r['wall_ms']:.3f} ms a run, {device}")
    for ev, calls, ms in r["events"][:top]:
        print(f"[{name}]   {ms:9.4f} ms  {calls:9.1f} calls  {ev[:90]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--edge-factor", type=int, default=32)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    g = rmat(scale=args.scale, edge_factor=args.edge_factor, seed=1,
             undirected=True)
    dg = to_device(g, with_csc=True, with_edge_src=True,
                   with_blocked_values=True, device=args.device)
    dev = dg.device
    print(f"graph: rmat n{args.scale} e{args.edge_factor} seed 1, "
          f"|V|={dg.num_nodes} |E|={dg.num_edges}, has_pull2 "
          f"{dg.has_pull2}, on {dev}")
    hub = g.largest_degree_vertex()
    cases = (
        ("pagerank power route", PR_ITERS,
         lambda: pagerank_device(dg, max_iters=PR_ITERS, threshold=0.0)),
        ("pagerank loop route", PR_ITERS,
         lambda: pagerank_device(dg, max_iters=PR_ITERS, threshold=0.0,
                                 instrument=[])),
        ("hits", HITS_ITERS, lambda: hits_device(dg, HITS_ITERS)),
        ("wtf", WTF_ITERS, lambda: wtf_device(dg, hub)),
    )
    for name, iters, fn in cases:
        print_profile(name, f"{iters} iterations, {args.runs} profiled runs",
                      profile_run(fn, args.runs, dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
