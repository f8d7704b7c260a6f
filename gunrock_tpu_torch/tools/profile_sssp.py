"""Device profile of SSSP and BFS: where a run spends its time on the
card, and how long the card idles.

    python -m gunrock_tpu_torch.tools.profile_sssp [--scale 20]
        [--edge-factor 32] [--grid-side 1024] [--runs 3] [--device cuda]
        [--only WORD ...]

Builds the graphs of ``chip_smoke.py`` phases 11-13: R-MAT (``--scale``,
``--edge-factor``, seed 1, undirected) with ``random_edge_values(seed=7)``,
and the ``--grid-side`` square grid with ``random_edge_values(seed=1)``,
both uploaded ``with_edge_values`` and ``with_blocked_values``. Profiles,
as :mod:`gunrock_tpu_torch.tools.profile_value` does (one warm-up run,
then ``--runs`` runs under ``torch.profiler``; one run on the grid):

  * SSSP on the R-MAT from its largest-degree vertex: the sweep route
    (kernel K6), near-far with delta 32 x the mean weight, and the same
    with ``fused=True`` (kernels K5, K3, K7, K8);
  * SSSP on the grid from 0 with delta 256 (the sweep route bails out to
    near-far and its deep micro-loop), the same with ``deep_carry=True``
    (the value-carry micro rounds), and non-DO BFS on the grid from 0
    (sweeps, bail-out, the deep micro-loop);
  * DO-BFS on the R-MAT from the same vertex, pulling through kernel K10
    (the graph above has no blocked CSC) and through K1 (the R-MAT
    uploaded ``with_blocked_csc``), and DO-BFS on the grid from 0 (the
    deep micro-loop);
  * BC (``bc_device``) on the R-MAT from the same vertex, the hybrid
    route and the hybrid fused (kernels K5, K7, K8 on its push levels),
    as ``chip_smoke.py`` phase 20 times them (``GUNROCK_BC_PULL2=0``).

Each prints ``best``, the best of ``--runs`` unprofiled runs fenced by a
device synchronize, then wall, device time and busy share (device /
wall) a profiled run, and the largest device events. ``--only`` keeps
the cases whose name holds one of its words.
"""

from __future__ import annotations

import argparse
import os
import time
from unittest.mock import patch

import numpy as np

from ..graph.csr import from_coo
from ..graph.device import sync, to_device
from ..io import rmat
from ..models.bc import bc_device
from ..models.bfs import bfs_device
from ..models.sssp import sssp_device
from .profile_value import print_profile, profile_run

TOP_EVENTS = 12


def grid(n: int):
    """The undirected ``n`` x ``n`` grid of ``bench_all.py:225-263``."""
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return from_coo(n * n, src, dst, undirected=True)


def with_env(fn, **env):
    """``fn`` run with the environment variables ``env`` set."""
    def run():
        with patch.dict(os.environ, env):
            return fn()
    return run


def best_ms(fn, runs: int, device) -> float:
    """Best of ``runs`` fenced runs of ``fn`` after a warm-up run."""
    fn()
    sync(device)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--edge-factor", type=int, default=32)
    p.add_argument("--grid-side", type=int, default=1024)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", nargs="*", default=None)
    args = p.parse_args(argv)
    g = rmat(scale=args.scale, edge_factor=args.edge_factor, seed=1,
             undirected=True)
    g.random_edge_values(seed=7)
    src = g.largest_degree_vertex()
    delta = 32.0 * float(np.mean(g.edge_values))
    dg = to_device(g, with_edge_values=True, with_blocked_values=True,
                   device=args.device)
    gg = grid(args.grid_side)
    gg.random_edge_values(seed=1)
    dgw = to_device(gg, with_edge_values=True, with_blocked_values=True,
                    device=args.device)
    dgb = to_device(g, with_csc=True, with_blocked_csc=True,
                    device=args.device)
    dev = dg.device
    print(f"graphs: rmat n{args.scale} e{args.edge_factor} seed 1 "
          f"(|E|={dg.num_edges}), grid {args.grid_side}x{args.grid_side} "
          f"(|E|={dgw.num_edges}), on {dev}")
    cases = (
        ("sssp sweep route", args.runs, lambda: sssp_device(dg, src)),
        ("sssp near-far", args.runs,
         lambda: sssp_device(dg, src, mode="nearfar", delta=delta)),
        ("sssp near-far fused", args.runs,
         lambda: sssp_device(dg, src, mode="nearfar", delta=delta,
                             fused=True)),
        ("sssp grid", 1,
         lambda: sssp_device(dgw, 0, mode="pull", delta=256.0)),
        ("sssp grid, deep_carry", 1,
         lambda: sssp_device(dgw, 0, mode="pull", delta=256.0,
                             deep_carry=True)),
        ("non-DO bfs grid", 1, lambda: bfs_device(dgw, 0)),
        ("DO-bfs, K10", args.runs,
         lambda: bfs_device(dg, src, direction_optimized=True)),
        ("DO-bfs, K1", args.runs,
         lambda: bfs_device(dgb, src, direction_optimized=True)),
        ("DO-bfs grid", 1,
         lambda: bfs_device(dgw, 0, direction_optimized=True)),
        ("bc hybrid", args.runs,
         with_env(lambda: bc_device(dg, src), GUNROCK_BC_PULL2="0")),
        ("bc hybrid fused", args.runs,
         with_env(lambda: bc_device(dg, src, fused=True),
                  GUNROCK_BC_PULL2="0")),
    )
    if args.only:
        cases = tuple(c for c in cases
                      if any(word in c[0] for word in args.only))
    for name, runs, fn in cases:
        best = best_ms(fn, runs, dev)
        print_profile(name, f"best {best:.3f} ms of {runs}; {runs} profiled "
                      f"runs", profile_run(fn, runs, dev), top=TOP_EVENTS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
