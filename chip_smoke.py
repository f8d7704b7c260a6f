#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (gunrock_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises and the
script exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions. Exits non-zero at once when CUDA is absent.
2. Build: compiles the CUDA kernels from ``gunrock_tpu_torch/csrc``.
3. Main path: direction-optimized BFS with predecessors through the
   public entry point ``gunrock_tpu_torch.bfs`` on R-MAT scale 20, edge
   factor 32, seed 1 (undirected), from the largest-degree vertex, with
   the kernels' launch counts reset just before and read just after.
   Labels are held against scipy's unweighted shortest paths,
   predecessors by validity, plus the structural checks of ``bench.py``.
4. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes, requiring exact equality, with median times from CUDA
   events.
5. Timing: best of 5 traversals after a warm-up, MTEPS in ``bench.py``'s
   accounting (out-degree sum over reached vertices / elapsed).
6. PageRank, power route: ``gunrock_tpu_torch.pagerank`` on the same
   graph uploaded ``with_blocked_values``, 20 iterations at threshold 0
   through kernel K4, held against the float64 numpy oracle; rank mass,
   order, and the iteration count of an early-stopping run.
7. PageRank, loop route (``instrumented``): kernel K3 an iteration,
   held against phase 6's ranks; per-iteration records. Then the host
   graph through ``gunrock_tpu_torch.pagerank(g, device="cuda")``, which
   uploads ``with_csc`` only and takes the loop route (K3).
8. HITS and SALSA through ``gunrock_tpu_torch.hits``/``salsa`` on CUDA
   (kernel K3 over the graph and its reverse view), held against their
   float64 numpy oracles.
9. K3 in four modes and K4 at 1 and 20 rounds against their plain
   PyTorch versions at the flagship's shapes: ``min`` exactly, sums
   within a relative tolerance; K3 bitwise equal over two launches; K4's
   change counts equal. Median times from CUDA events.
10. Timing: best of 5 PageRank (both routes) and HITS runs after a
    warm-up: ms per iteration and MTEPS (num_edges x iterations, twice
    that for HITS, per ms).

Each phase's kernel launch counts are reset just before it and read just
after; the ``launches`` of the JSON line come from phases 3 (K1, K2), 6
(K4) and 7-8 (K3).

The last two lines are a JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

SCALE, EDGE_FACTOR, SEED = 20, 32, 1
RUNS = 5
TIMED_LAUNCHES = 20
BFS_KERNELS = ("pull_reached_words", "bitmask_gather")
PR_ITERS, LINK_ITERS = 20, 10


def _median_ms(fn, reps: int = TIMED_LAUNCHES) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up launch."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def check_labels(g, src, labels):
    """Labels equal scipy's unweighted shortest-path depths."""
    import numpy as np
    import scipy.sparse
    from scipy.sparse.csgraph import shortest_path
    a = scipy.sparse.csr_matrix(
        (np.ones(g.num_edges, np.float32), g.col_indices, g.row_offsets),
        shape=(g.num_nodes, g.num_nodes))
    dist = shortest_path(a, method="D", unweighted=True, indices=src)
    ref = np.where(np.isinf(dist), -1, dist).astype(np.int32)
    bad = int((ref != labels).sum())
    if bad:
        raise AssertionError(f"{bad} labels differ from scipy's depths")


def check_preds(g, src, labels, preds):
    """pred[v] is an in-neighbour of v one level up; -1 at the source and
    at unreached vertices."""
    import numpy as np
    v = np.nonzero(labels > 0)[0]
    p = preds[v].astype(np.int64)
    if preds[src] != -1 or (preds[labels < 0] != -1).any():
        raise AssertionError("pred is set at the source or an unreached "
                             "vertex")
    if (p < 0).any() or (labels[p] != labels[v] - 1).any():
        raise AssertionError("a predecessor is not one level up")
    # CSR edge keys (src * V + dst) are sorted: CSR rows are sorted.
    keys = g.edge_sources().astype(np.int64) * g.num_nodes + g.col_indices
    q = p * g.num_nodes + v
    at = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    if (keys[at] != q).any():
        raise AssertionError("a predecessor is not an in-neighbour")


def check_structure(g, src, lab):
    """The structural checks of bench.py (labels differ by at most one
    across an edge; a reached vertex has no unreached neighbour)."""
    import numpy as np
    reached = lab >= 0
    if lab[src] != 0:
        raise AssertionError("src label wrong")
    rng = np.random.default_rng(0)
    probe = rng.integers(0, g.num_edges, 200_000)
    es = g.edge_sources()[probe]
    ed = g.col_indices[probe]
    both = reached[es] & reached[ed]
    if not (np.abs(lab[es][both].astype(np.int64)
                   - lab[ed][both].astype(np.int64)) <= 1).all():
        raise AssertionError("BFS label property violated")
    if (reached[es] & ~reached[ed]).any():
        raise AssertionError("reached vertex with unreached neighbour")


def check_close(what, got, want, *, rtol, atol):
    """Raise unless |got - want| <= atol + rtol * |want| everywhere; print
    the largest errors."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    bad = int((err > atol + rtol * np.abs(want)).sum())
    rel = float((err / np.maximum(np.abs(want), 1e-30)).max())
    print(f"[check] {what}: max abs err {float(err.max()):.3e}, max rel err "
          f"{rel:.3e} (rtol {rtol}, atol {atol}), {bad} outside")
    if bad:
        raise AssertionError(f"{what}: {bad} values outside the tolerance")


def _errs(got, want) -> tuple[float, float]:
    """(max abs, max rel) error of a float tensor against its reference;
    equal entries (0 or inf on both sides) count 0."""
    import torch
    err = torch.where(got == want, 0.0, (got.double() - want.double()).abs())
    rel = err / want.double().abs().clamp(min=1e-30)
    return float(err.max()), float(rel.max())


def phase_pagerank(gtt, g, dev):
    """Phases 6 and 7: PageRank's power route (K4) and loop route (K3)
    through ``gtt.pagerank`` on the flagship, held against the float64
    oracle. Returns the graph and the main-path launch counts."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.utils import reference as oracle

    # 6. Power route.
    t0 = time.perf_counter()
    dg = gtt.to_device(g, with_csc=True, with_edge_src=True,
                       with_blocked_values=True, device="cuda")
    torch.cuda.synchronize()
    print(f"[pr] to_device(with_csc, with_edge_src, with_blocked_values) "
          f"{time.perf_counter() - t0:.3f} s; has_pull2 {dg.has_pull2}")
    if not dg.has_pull2:
        raise AssertionError("the flagship should take the power route")
    K.reset_launch_counts()
    power = gtt.pagerank(dg, max_iters=PR_ITERS, threshold=0.0)
    torch.cuda.synchronize()
    power_launches = dict(K.LAUNCHES)
    print(f"[pr] power route: iterations {power.info['num_iterations']}, "
          f"process {power.info['process_ms']:.3f} ms, kernel launches "
          f"{power_launches}")
    if power_launches["pull_power_iters"] <= 0:
        raise AssertionError("K4 was not launched on the power route")
    if power.info["num_iterations"] != PR_ITERS:
        raise AssertionError(f"{power.info['num_iterations']} iterations, "
                             f"expected {PR_ITERS} at threshold 0")
    t0 = time.perf_counter()
    ref = oracle.cpu_pagerank(g, 0.85, PR_ITERS, tol=0.0)
    print(f"[pr] float64 oracle {time.perf_counter() - t0:.3f} s")
    check_close("pagerank power route vs float64 oracle", power.ranks, ref,
                rtol=1e-3, atol=1e-9)
    # Isolated vertices (no edges) keep only the reset mass, so the total
    # is below 1 by the same amount in the oracle.
    mass = float(power.ranks.astype(np.float64).sum())
    isolated = int((np.diff(g.row_offsets) == 0).sum())
    print(f"[pr] rank mass {mass:.7f}, oracle {float(ref.sum()):.7f} "
          f"({isolated} isolated vertices)")
    if abs(mass - float(ref.sum())) > 1e-4:
        raise AssertionError("rank mass differs from the oracle's")
    ids = power.node_ids
    if not np.array_equal(np.sort(ids), np.arange(g.num_nodes)) or \
            (np.diff(power.ranks[ids]) > 0).any():
        raise AssertionError("node_ids is not a descending rank order")
    early = gtt.pagerank(dg, max_iters=50, threshold=1e-6)
    print(f"[pr] early stop (threshold 1e-6, max 50): iterations "
          f"{early.info['num_iterations']}, changed per iteration "
          f"{early.info['per_iteration_frontier']}")

    # 7. Loop route.
    K.reset_launch_counts()
    loop = gtt.pagerank(dg, max_iters=PR_ITERS, threshold=0.0,
                        instrumented=True)
    torch.cuda.synchronize()
    loop_launches = dict(K.LAUNCHES)
    print(f"[pr] loop route: kernel launches {loop_launches}")
    if loop_launches["pull_reduce2"] <= 0:
        raise AssertionError("K3 was not launched on the loop route")
    check_close("pagerank loop route vs power route", loop.ranks,
                power.ranks, rtol=1e-4, atol=0.0)
    print("[pr] loop route per iteration: " + ", ".join(
        f"{r['iteration']}:{r['ms']:.3f} ms/{r['updated']}"
        for r in loop.info["per_iteration"]))
    host = gtt.pagerank(g, max_iters=PR_ITERS, threshold=0.0, device="cuda")
    torch.cuda.synchronize()
    host_k3 = K.LAUNCHES["pull_reduce2"] - loop_launches["pull_reduce2"]
    print(f"[pr] host graph, pagerank(g, device='cuda'): preprocess "
          f"{host.info['preprocess_ms']:.3f} ms, process "
          f"{host.info['process_ms']:.3f} ms, K3 launches {host_k3}")
    if host_k3 != PR_ITERS:
        raise AssertionError(f"the host graph's run launched K3 {host_k3} "
                             f"times, expected {PR_ITERS}")
    check_close("pagerank of the host graph vs power route", host.ranks,
                power.ranks, rtol=1e-4, atol=0.0)
    loop_launches["pull_reduce2"] += host_k3
    return dg, power_launches, loop_launches


def phase_link_analysis(gtt, g):
    """Phase 8: HITS and SALSA through their entry points on CUDA, held
    against the float64 oracles with the JAX CLI's tolerances. Returns
    K3's launches over both runs."""
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.utils import reference as oracle
    launches = 0
    for prim, atol in (("hits", 1e-4), ("salsa", 1e-5)):
        K.reset_launch_counts()
        res = getattr(gtt, prim)(g, max_iters=LINK_ITERS, device="cuda")
        torch.cuda.synchronize()
        n = K.LAUNCHES["pull_reduce2"]
        print(f"[{prim}] preprocess {res.info['preprocess_ms']:.3f} ms, "
              f"process {res.info['process_ms']:.3f} ms, kernel launches "
              f"{dict(K.LAUNCHES)}")
        if n <= 0:
            raise AssertionError(f"K3 was not launched by {prim}")
        launches += n
        hub, auth = getattr(oracle, f"cpu_{prim}")(g, LINK_ITERS)
        check_close(f"{prim} hubs vs float64 oracle", res.hubs, hub,
                    rtol=1e-3, atol=atol)
        check_close(f"{prim} auths vs float64 oracle", res.auths, auth,
                    rtol=1e-3, atol=atol)
    return launches


def phase_value_kernels(dg, dev):
    """Phase 9: K3 in four modes and K4 at 1 and PR_ITERS rounds against
    their plain versions at the flagship's shapes. Returns the JSON
    fields of both."""
    import dataclasses
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import pull2 as P
    rng = np.random.default_rng(SEED)
    vals = torch.from_numpy(rng.random(dg.v_pad, dtype=np.float32)).to(dev)
    init = torch.from_numpy(rng.random(dg.v_pad, dtype=np.float32)).to(dev)
    # Random CSC edge values in CsrGraph.random_edge_values' range.
    ev = np.zeros(dg.e_pad, np.float32)
    ev[:dg.num_edges] = rng.uniform(0.0, 64.0, dg.num_edges)
    dgv = dataclasses.replace(dg, csc_edge_values=torch.from_numpy(ev).to(dev))
    k3 = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for name, kw in (("sum/none", dict(op="sum", wmode="none")),
                     ("sum/mul/wpr", dict(op="sum", wmode="mul",
                                          weights="wpr")),
                     ("min/add/val", dict(op="min", wmode="add",
                                          weights="val")),
                     ("min/none/init", dict(op="min", wmode="none",
                                            init=init))):
        got = P.pull_reduce2(vals, dgv, **kw)
        again = P.pull_reduce2(vals, dgv, **kw)
        want = P.pull_reduce2_plain(vals, dgv, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {name}: two launches differ")
        abs_err, rel_err = _errs(got, want)
        if kw["op"] == "min" and not torch.equal(got, want):
            raise AssertionError(f"K3 {name} differs from its plain version")
        if rel_err > 1e-5:
            raise AssertionError(f"K3 {name}: max rel err {rel_err:.3e}")
        ms = _median_ms(lambda: P.pull_reduce2(vals, dgv, **kw))
        plain = _median_ms(lambda: P.pull_reduce2_plain(vals, dgv, **kw),
                           reps=5)
        print(f"[kernels] K3 pull_reduce2 {name}: bitwise equal over two "
              f"launches; max abs err {abs_err:.3e}, max rel err "
              f"{rel_err:.3e}; {ms:.4f} ms vs plain {plain:.4f} ms")
        k3["max_abs_err"] = max(k3["max_abs_err"], abs_err)
        k3["max_rel_err"] = max(k3["max_rel_err"], rel_err)
        if name == "sum/none":   # the mode HITS, SALSA and the loop run
            k3["ms"], k3["plain_ms"] = ms, plain
    n = dg.num_nodes
    start = torch.where(torch.arange(dg.v_pad, device=dev) < n, 1.0 / n,
                        0.0).float()
    kw = dict(damping=0.85, reset=0.15 / n, threshold=1e-6)
    k4 = {}
    for iters, rtol in ((1, 1e-5), (PR_ITERS, 1e-3)):
        rank, chg = P.pull_power_iters(dg, start, iters=iters, **kw)
        want, want_chg = P.pull_power_iters_plain(dg, start, iters=iters,
                                                  **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = _errs(rank, want)
        if rel_err > rtol:
            raise AssertionError(f"K4 {iters} rounds: max rel err "
                                 f"{rel_err:.3e}")
        if not torch.equal(chg, want_chg):
            raise AssertionError(f"K4 {iters} rounds: change counts "
                                 f"{chg.tolist()} vs {want_chg.tolist()}")
        ms = _median_ms(lambda: P.pull_power_iters(dg, start, iters=iters,
                                                   **kw))
        plain = _median_ms(lambda: P.pull_power_iters_plain(
            dg, start, iters=iters, **kw), reps=3)
        print(f"[kernels] K4 pull_power_iters {iters} rounds: max abs err "
              f"{abs_err:.3e}, max rel err {rel_err:.3e} (rtol {rtol}); "
              f"change counts equal {chg.tolist()}; {ms:.4f} ms vs plain "
              f"{plain:.4f} ms")
        k4 = {"max_abs_err": max(k4.get("max_abs_err", 0.0), abs_err),
              "max_rel_err": max(k4.get("max_rel_err", 0.0), rel_err),
              "ms": ms, "plain_ms": plain}
    return k3, k4


def phase_value_timing(dg, card):
    """Phase 10: best of RUNS PageRank (both routes) and HITS runs after a
    warm-up, graph on the card, fenced with torch.cuda.synchronize()."""
    import torch
    from gunrock_tpu_torch.models.hits import hits_device
    from gunrock_tpu_torch.models.pr import pagerank_device

    def best_of(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), times

    for name, fn, iters, edges in (
            ("pagerank power route",
             lambda: pagerank_device(dg, max_iters=PR_ITERS, threshold=0.0),
             PR_ITERS, dg.num_edges),
            ("pagerank loop route",
             lambda: pagerank_device(dg, max_iters=PR_ITERS, threshold=0.0,
                                     instrument=[]),
             PR_ITERS, dg.num_edges),
            ("hits", lambda: hits_device(dg, LINK_ITERS),
             LINK_ITERS, 2 * dg.num_edges)):
        best, times = best_of(fn)
        print(f"[timing] {name}: best {best:.3f} ms of {RUNS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); {iters} "
              f"iterations, {best / iters:.4f} ms/iteration, "
              f"{edges * iters / (best * 1000.0):.1f} MTEPS; on {card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import gunrock_tpu_torch as gtt
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.ops import _build
    from gunrock_tpu_torch.ops import kernels as K

    # 1. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[env] nvidia-smi: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(dev)}, "
          f"count {torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"[build] {os.path.relpath(lib_path)} in "
          f"{time.perf_counter() - t0:.3f} s")
    with open(lib_path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # 3. Main path.
    t0 = time.perf_counter()
    g = gtt.io.rmat(scale=SCALE, edge_factor=EDGE_FACTOR, seed=SEED,
                    undirected=True)
    print(f"[graph] rmat n{SCALE} e{EDGE_FACTOR} seed {SEED}: "
          f"|V|={g.num_nodes} |E|={g.num_edges}, host build "
          f"{time.perf_counter() - t0:.3f} s")
    src = g.largest_degree_vertex()
    K.reset_launch_counts()
    res = gtt.bfs(g, src="largestdegree", mark_preds=True,
                  direction_optimized=True, instrumented=True, device="cuda")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    info = res.info
    phases = [r["phase"] for r in info["per_iteration"]]
    print(f"[main] src {src}, search_depth {info['search_depth']}, "
          f"iterations {info['num_iterations']}, edges_visited "
          f"{info['edges_visited']}, preprocess "
          f"{info['preprocess_ms']:.3f} ms, process "
          f"{info['process_ms']:.3f} ms")
    print(f"[main] levels: " + ", ".join(
        f"{r['iteration']}:{r['phase']}(n={r['frontier']}, "
        f"{r['ms']:.3f} ms)" for r in info["per_iteration"]))
    print(f"[main] kernel launches: {launches}")
    for name in BFS_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if "pull" not in phases:
        raise AssertionError(f"push/pull sequence {phases} has no pull")
    t0 = time.perf_counter()
    check_labels(g, src, res.labels)
    check_preds(g, src, res.labels, res.preds)
    check_structure(g, src, res.labels)
    print(f"[main] labels equal scipy's shortest-path depths; preds valid; "
          f"structural checks pass ({time.perf_counter() - t0:.3f} s)")

    # 4. Kernels against their plain versions at the main path's shapes.
    dg = gtt.to_device(g, with_csc=True, device=dev)
    labels = torch.from_numpy(res.labels).to(dev)
    labels = torch.cat([labels, labels.new_full(
        (dg.v_pad - g.num_nodes,), -1)])
    rng = np.random.default_rng(SEED)
    masks = {f"level {d}": labels == d
             for d in range(info["search_depth"] + 1)}
    for dens in (0.001, 0.3):
        masks[f"random {dens}"] = torch.from_numpy(
            rng.random(dg.v_pad) < dens).to(dev)
    pull_levels = {f"level {r['iteration'] - 1}"
                   for r in info["per_iteration"] if r["phase"] == "pull"}
    k1_ms = k1_plain_ms = 0.0
    k1_err = 0
    for name, mask in masks.items():
        words = K.pack_bitmask(mask)
        got = K.pull_reached_words(words, dg)
        want = K.pull_reached_words_plain(words, dg)
        k1_err = max(k1_err, _max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{name}")
        ms = _median_ms(lambda: K.pull_reached_words(words, dg))
        plain = _median_ms(
            lambda: K.pull_reached_words_plain(words, dg))
        if name in pull_levels:
            k1_ms += ms
            k1_plain_ms += plain
        print(f"[kernels] K1 pull_reached_words {name} "
              f"({int(mask.sum())} frontier bits): equal, "
              f"{ms:.4f} ms vs plain {plain:.4f} ms")
    idx = torch.from_numpy(
        rng.integers(0, dg.v_pad, 1 << 22).astype(np.int32)).to(dev)
    words = K.pack_bitmask(labels == -1)
    got = K.bitmask_gather(words, idx)
    want = K.bitmask_gather_plain(words, idx)
    k2_err = _max_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError("K2 differs from its plain version")
    k2_ms = _median_ms(lambda: K.bitmask_gather(words, idx))
    k2_plain_ms = _median_ms(lambda: K.bitmask_gather_plain(words, idx))
    print(f"[kernels] K2 bitmask_gather 2^22 random ids: equal, "
          f"{k2_ms:.4f} ms vs plain {k2_plain_ms:.4f} ms")
    print(f"[kernels] K1 summed over the main path's pull levels "
          f"{sorted(pull_levels)}: {k1_ms:.4f} ms vs plain "
          f"{k1_plain_ms:.4f} ms")

    # 5. Timing, as bench.py times the flagship: bfs_device on the
    # uploaded graph, no predecessors, best of RUNS after a warm-up.
    def run():
        out = bfs_device(dg, src, direction_optimized=True)
        torch.cuda.synchronize()
        return out

    lab_t, _, _ = run()
    if not torch.equal(lab_t[:g.num_nodes].cpu(),
                       torch.from_numpy(res.labels)):
        raise AssertionError("timed traversal's labels differ")
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    best = min(times)
    mteps = info["edges_visited"] / (best * 1000.0)
    per_level = []
    bfs_device(dg, src, direction_optimized=True, instrument=per_level)
    print(f"[timing] elapsed_ms best {best:.3f} of {RUNS} "
          f"({', '.join(f'{t:.3f}' for t in times)}); {mteps:.1f} MTEPS "
          f"(edges_visited {info['edges_visited']}); search_depth "
          f"{info['search_depth']}; on {card}")
    print(f"[timing] per level: " + ", ".join(
        f"{r['iteration']}:{r['phase']} {r['ms']:.3f} ms"
        for r in per_level))
    print(f"[timing] card: {card}")

    # 6-7. PageRank; 8. HITS and SALSA; 9. K3/K4 against their plain
    # versions; 10. timing of the value primitives.
    dg, power_launches, loop_launches = phase_pagerank(gtt, g, dev)
    link_launches = phase_link_analysis(gtt, g)
    k3, k4 = phase_value_kernels(dg, dev)
    phase_value_timing(dg, card)

    source = "gunrock_tpu_torch/csrc/bfs_kernels.cu"
    pull_source = "gunrock_tpu_torch/csrc/pull_kernels.cu"
    print(json.dumps({"kernels": [
        {"name": "pull_reached_words", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:257",
         "launches": launches["pull_reached_words"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "bitmask_gather", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:71",
         "launches": launches["bitmask_gather"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "pull_reduce2", "route": "cuda", "source": pull_source,
         "replaces": "gunrock_tpu/ops/pull2.py:57",
         "launches": loop_launches["pull_reduce2"] + link_launches, **k3},
        {"name": "pull_power_iters", "route": "cuda", "source": pull_source,
         "replaces": "gunrock_tpu/ops/pull2.py:605",
         "launches": power_launches["pull_power_iters"], **k4},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
