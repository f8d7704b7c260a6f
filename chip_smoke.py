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
    for name, count in launches.items():
        if count <= 0:
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

    source = "gunrock_tpu_torch/csrc/bfs_kernels.cu"
    print(json.dumps({"kernels": [
        {"name": "pull_reached_words", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:257",
         "launches": launches["pull_reached_words"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "bitmask_gather", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:71",
         "launches": launches["bitmask_gather"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
