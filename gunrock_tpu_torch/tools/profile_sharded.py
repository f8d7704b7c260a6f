"""The sharded traversals on the stacked mesh: wall time and host reads.

    python -m gunrock_tpu_torch.tools.profile_sharded [--scale 20]
        [--edge-factor 32] [--shards 4] [--reps 5] [--device cuda]

Builds the graph of ``chip_smoke.py`` (R-MAT ``--scale``,
``--edge-factor``, seed 1, undirected, ``random_edge_values(seed=7)``),
partitions it as phase 31 does (``random``, seed 0, with the CSC, the
ghost tables and the weights, every shard stacked on ``--device``) and
runs from the largest-degree vertex, as phase 31 calls them:

  * DO-BFS with predecessors, pulls through K1 on the global shard views;
  * non-DO BFS with predecessors;
  * SSSP near-far (delta 32 times the mean weight), pull-relax through
    K3 min/add on the compact shard tables.

Each case runs once to warm up, then ``--reps`` times fenced (the
card synchronized before and after); it prints the median, least and
largest wall ms, the supersteps, a digest of the result (equal digests:
equal bits), the host reads of one more run (the synchronizing calls
that ``torch.cuda.set_sync_debug_mode`` reports; none on the CPU) and,
from one run under ``torch.profiler``, the ATen operators the host
dispatched, the kernels the card ran and the sum of their times ("not
measured" on the CPU). The module runs on any tree of the port that has
these entry points, so that two trees can be compared in one call, in
turns.
"""

from __future__ import annotations

import argparse
import hashlib
import statistics
import time
import warnings

import numpy as np
import torch

from gunrock_tpu_torch import parallel as SP
from gunrock_tpu_torch.io import rmat
from gunrock_tpu_torch.parallel.blocked import blocked_from_partition


def _digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _host_reads(fn, dev) -> int:
    """The synchronizing calls of one run of ``fn`` on a card."""
    if dev.type != "cuda":
        return 0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _profiled(fn, dev) -> str:
    """The host's ATen operators and the card's kernels in one run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    events = prof.events()
    ops = sum(e.device_type == DeviceType.CPU and e.name.startswith("aten::")
              for e in events)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        return f"{ops} ATen operators, kernels not measured"
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return (f"{ops} ATen operators, {len(kernels)} kernels busy "
            f"{busy:.3f} ms")


def _fenced_ms(fn, dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--edge-factor", type=int, default=32)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    g = rmat(scale=args.scale, edge_factor=args.edge_factor, seed=1,
             undirected=True)
    g.random_edge_values(seed=7)
    src = g.largest_degree_vertex()
    delta = 32.0 * float(np.mean(g.edge_values))
    mesh = SP.make_mesh(args.shards, device=args.device)
    dev = mesh.device
    pg, perm = SP.partition(g, args.shards, method="random", with_csc=True,
                            with_ghosts=True, with_edge_values=True,
                            device=dev)
    src_new = int(perm[src])
    glob = blocked_from_partition(pg)
    min_add = blocked_from_partition(pg, compact=True, edge_weight="csc")
    print(f"rmat n{args.scale} e{args.edge_factor} seed 1 (|E|="
          f"{g.num_edges}), {args.shards} shards stacked on {dev}, src "
          f"{src}")
    cases = (
        ("DO-BFS (K1)", lambda: SP.bfs_sharded_device(
            pg, src_new, mesh=mesh, mark_preds=True,
            direction_optimized=True, blocked=glob),
         lambda r: (r[2], _digest(r[0], r[1]))),
        ("non-DO BFS", lambda: SP.bfs_sharded_device(
            pg, src_new, mesh=mesh, mark_preds=True),
         lambda r: (r[2], _digest(r[0], r[1]))),
        ("SSSP near-far (K3)", lambda: SP.sssp_sharded_device(
            pg, src_new, mesh=mesh, mode="nearfar", delta=delta,
            blocked=min_add),
         lambda r: (r[1], _digest(r[0]))),
    )
    for name, fn, read in cases:
        steps, digest = read(fn())
        times = [_fenced_ms(fn, dev) for _ in range(args.reps)]
        reads = _host_reads(fn, dev)
        print(f"{name}: median {statistics.median(times):.3f} ms, least "
              f"{min(times):.3f}, most {max(times):.3f} over {args.reps} "
              f"runs; supersteps {steps}, host reads {reads} "
              f"({reads / max(steps, 1):.2f} a superstep), digest {digest}; "
              f"one run: {_profiled(fn, dev)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
