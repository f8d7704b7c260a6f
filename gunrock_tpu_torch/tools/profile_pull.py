"""Where K3's time goes, and K8's: the device time of a call against the
host's, and K3's edge stream against its gathers; and the device time of
K4, which runs K3's pass, of the activity-gated pulls K6 and K9, of the
BFS pulls K1 and K10 and of the push filter K2 at the shapes of
``chip_smoke.py``.

    python -m gunrock_tpu_torch.tools.profile_pull [--scale 20]
        [--edge-factor 32] [--winners 135241] [--reps 20] [--device cuda]

Builds R-MAT (``--scale``, ``--edge-factor``, seed 1, undirected), the
graph of ``chip_smoke.py``, with ``random_edge_values(seed=7)``, uploads
it ``with_csc`` and ``with_edge_values`` and profiles, as
:mod:`gunrock_tpu_torch.tools.profile_value` does (one warm-up call,
then ``--reps`` calls under ``torch.profiler``):

  * K3 ``pull_reduce2`` sum/none over the graph (the mode of HITS, SALSA
    and the PageRank loop), and ``torch.mv`` over the same CSC as a
    sparse CSR matrix;
  * K3 over the same graph with every source replaced by vertex 0: the
    same edge stream, rows and launches, but every gather reads one
    value, so the difference from the first row is what the gathers
    cost;
  * K8 ``scatter_sorted`` min of ``--winners`` sorted unique ids with the
    count on the device, in a buffer of v_pad lanes (the shapes of
    ``chip_smoke.py`` phase 14), and ``index_reduce_`` amin of the same;
  * K4 ``pull_power_iters``: 20 PageRank rounds from 1/n (phase 9's
    shape) at threshold 0 and at 1e-6, each split on the card into the
    tile rows (once a call), K3's pass 1 a round and the rest of a round
    (the folds, the finish and the counts' fill);
  * the PageRank power route as a user calls it: ``pagerank`` with its
    defaults (threshold 1e-6, at most 50 rounds, K4 calls of 10 rounds
    with a host read after each) on the graph uploaded
    ``with_blocked_values``;
  * K6 ``pull_min_sweeps``: 6 sweeps add/val from the largest-degree
    vertex (phase 14), its first sweep alone, and 3 sweeps continuing
    from the distances of 3 plain sweeps (every finite source active
    at the call's start);
  * K9 ``brandes_fwd_levels`` / ``brandes_bwd_levels``: one BC source
    from that vertex, forward levels in calls of 8 until one labels
    nobody, then the backward rings (phase 19; a host read a call);
  * K5 and K7 at the push round of ``chip_smoke.py`` phase 14 (the same
    frontier: vertices taken in a seeded random order while their degree
    sum stays under E / 16, sorted; half of the SSSP distances from that
    vertex set to +inf): K5's pair (``sample_sorted2`` of the columns and
    weights at the edge ids, ``sample_sorted`` of the distances at the
    sources), K7's min with aux on the lanes sorted by destination, and
    K7's sum by source (BC's backward ring) over that frontier with the
    largest-degree vertex added, whose run spans many of K7's tiles;
  * K1 ``pull_reached_words`` and K10 ``bitmask_gather_cumsum`` at the
    pull levels of DO-BFS from the largest-degree vertex (the frontiers
    of ``chip_smoke.py`` phases 4 and 22; on a graph too small to pull,
    the level of the largest frontier): one case runs every level's
    call, so the device events split by kernel and count the launches;
    K1 also with every source replaced by vertex 0 (the same edge
    stream, rows and launches, every mask read one word), and K10 with
    the mask read through L1 (``K10L1``, the variant for masks above the
    shared-memory cap) where the size rule would hold it in shared
    memory;
  * K2 ``bitmask_gather`` over a mask of v_pad bits (half of them set,
    seeded): at the main path's launch, the largest-degree vertex's
    neighbours as the single-source push slices them from
    ``col_indices`` (a view at any 4-byte offset), also with a 64 MB fill
    before each call, so that the ids come from device memory as on the
    main path, and at 2^22 random ids.

``--only`` keeps the cases whose name holds one of its words (``K5``,
``K7``, ...; ``K1`` keeps K1, K10 and K10's L1 variant, ``"K1 "
"K10 "`` the wrappers alone; ``K2`` keeps K2's cases).

Each prints wall and device time a call and the device events,
``host``: the median time until a call returns unfenced, over ``--reps``
calls (the host path alone, the device work being asynchronous), and
``call``: the median time of a call between two CUDA events, the host
path included where the card waits on it (``chip_smoke.py``'s ``ms``). On the
card it then splits K8's host path: the wrapper, ``_launch`` with the
arguments ready, and the C entry point alone. On the CPU the profiler
records no device events, and device prints as "not measured".
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from ..graph.device import sync, to_device
from ..io import rmat
from ..models.bfs import bfs_device
from ..models.pr import pagerank
from ..ops import kernels as K
from ..ops import pull2 as P
from ..ops.advance import expand
from .profile_value import print_profile, profile_run


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return f"{device.type} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def host_ms(fn, reps: int, device: torch.device) -> float:
    """Median time until a call of ``fn`` returns, unfenced, after a
    warm-up; the device is drained between calls."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        sync(device)
    return float(np.median(times))


def call_ms(fn, reps: int, device: torch.device):
    """Median time of a call on the card's clock (a CUDA event before and
    after, the host path included where the card waits on it), after a
    warm-up, as ``chip_smoke.py`` times a kernel; None off the card."""
    if device.type != "cuda":
        return None
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
    return float(np.median(times))


def brandes_source(dg, src: int, levels: int = 8):
    """One BC source through K9 as the kernel-C route runs it: forward
    levels in calls of ``levels`` until one labels nobody, then every
    backward ring; returns the final delta."""
    dev = dg.csc_indices.device
    lab = torch.full((dg.v_pad,), float("inf"), device=dev)
    lab[src] = 0.0
    sig = torch.zeros(dg.v_pad, device=dev)
    sig[src] = 1.0
    d = 1
    while True:
        lab, sig, chg = P.brandes_fwd_levels(dg, lab, sig, d0=d,
                                             levels=levels)
        chg = chg.tolist()
        if 0 in chg:
            depth = d + chg.index(0) - 1
            break
        d += levels
    delta = torch.zeros(dg.v_pad, device=dev)
    for t in range(depth - 1, -1, -levels):
        delta, _ = P.brandes_bwd_levels(dg, lab, sig, delta, t0=t,
                                        levels=min(levels, t + 1))
    return delta


def power_split(r: dict, rounds: int) -> dict:
    """K4's device time from a :func:`profile_run` of one call, by part:
    ``build`` the tile rows a call (``tile_rows_kernel``), ``pass1`` K3's
    pass 1 a round (``pull_tiles_kernel``) and ``rest`` everything else a
    round (the folds, the finish, the counts' fill). The launches run one
    after another on one stream, so the parts add up to the device
    time."""
    def part(key):
        return sum(ms for ev, _, ms in r["events"] if key in ev)
    build, pass1 = part("tile_rows"), part("pull_tiles")
    return {"build": build, "pass1": pass1 / rounds,
            "rest": (r["device_ms"] - build - pass1) / rounds}


def sssp_distances(dg, src: int) -> torch.Tensor:
    """SSSP distances from ``src`` by K6 sweeps to their fixpoint."""
    d = torch.full((dg.v_pad,), float("inf"), device=dg.device)
    d[src] = 0.0
    while True:
        d, chg = P.pull_min_sweeps(dg, d, sweeps=6)
        if int(chg[-1]) == 0:
            return d


def push_round(dg, hub: int) -> dict:
    """The inputs of K5 and K7 at ``chip_smoke.py`` phase 14's push round,
    and a BC-like sum by source over the same frontier with ``hub``
    added."""
    rng = np.random.default_rng(1)
    dev = dg.device
    deg = (dg.row_offsets[1:] - dg.row_offsets[:-1]).long()
    perm = torch.from_numpy(rng.permutation(dg.num_nodes)).to(dev)
    take = torch.cumsum(deg[perm], 0) <= dg.num_edges // 16
    frontier = torch.sort(perm[take]).values.to(torch.int32)
    ex = expand(dg, frontier, with_dst=False)
    dist = sssp_distances(dg, hub)
    half = torch.where(torch.from_numpy(rng.random(dg.v_pad) < 0.5).to(dev),
                       float("inf"), dist)
    dst, w = K.sample_sorted2(dg.col_indices, dg.edge_values, ex.eid)
    sd, order = torch.sort(dst, stable=True)
    cand = (K.sample_sorted(half, ex.src) + w)[order]
    with_hub = torch.unique(torch.cat([frontier, torch.tensor(
        [hub], dtype=torch.int32, device=dev)]))
    exh = expand(dg, with_hub, with_dst=False)
    add = torch.from_numpy(rng.random(exh.total, dtype=np.float32)).to(dev)
    return {"ex": ex, "half": half, "sd": sd, "cand": cand,
            "aux": half[sd.long()], "out_min": min(dg.e_pad, dg.v_pad),
            "src": exh.src, "add": add,
            "out_sum": min(exh.total, dg.v_pad) + 128}


def pull_frontiers(dg, hub: int) -> tuple[list, list]:
    """The depths of DO-BFS's pull levels from ``hub`` (the level of the
    largest frontier where none pulls) and each one's packed frontier."""
    records = []
    labels, _, _ = bfs_device(dg, hub, direction_optimized=True,
                              instrument=records)
    depths = [r["iteration"] - 1 for r in records if r["phase"] == "pull"]
    if not depths:
        sizes = torch.bincount(labels[labels >= 0].long())
        depths = [int(torch.argmax(sizes))]
    return depths, [K.pack_bitmask(labels == d) for d in depths]


def k2_cases(dg, hub: int, rng) -> tuple:
    """K2's cases (see the module docstring): the main path's launch,
    warm and cold, and 2^22 random ids."""
    dev = dg.device
    words = K.pack_bitmask(torch.from_numpy(rng.random(dg.v_pad) < 0.5)
                           .to(dev))
    start, end = dg.row_offsets[hub:hub + 2].tolist()
    nbr = dg.col_indices[start:end]
    ids = torch.from_numpy(rng.integers(0, dg.v_pad, 1 << 22)
                           .astype(np.int32)).to(dev)
    at = f"offset {nbr.data_ptr() % 16} bytes mod 16"
    # Larger than the H100's 50 MB L2: zeroed before a call, it leaves
    # the ids cold, as the main path finds them.
    flush = torch.empty(1 << 24, dtype=torch.float32, device=dev)
    return (
        (f"K2 bitmask_gather, the hub's {nbr.shape[0]} neighbours ({at})",
         lambda: K.bitmask_gather(words, nbr)),
        (f"K2 bitmask_gather, the hub's neighbours, L2 flushed before each "
         f"call (the fill's events apart)",
         lambda: (flush.zero_(), K.bitmask_gather(words, nbr))),
        (f"K2 bitmask_gather, {ids.shape[0]} random ids",
         lambda: K.bitmask_gather(words, ids)),
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--edge-factor", type=int, default=32)
    p.add_argument("--winners", type=int, default=135_241)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", nargs="*", default=None)
    args = p.parse_args(argv)
    g = rmat(scale=args.scale, edge_factor=args.edge_factor, seed=1,
             undirected=True)
    g.random_edge_values(seed=7)
    dg = to_device(g, with_csc=True, with_edge_values=True,
                   device=args.device)
    dev = dg.device
    print(f"[profile_pull] rmat n{args.scale} e{args.edge_factor} seed 1, "
          f"|V|={dg.num_nodes} |E|={dg.num_edges}, on {_card(dev)}")
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.random(dg.v_pad, dtype=np.float32)).to(dev)
    e = dg.num_edges
    csr = torch.sparse_csr_tensor(dg.csc_offsets, dg.csc_indices[:e],
                                  torch.ones(e, device=dev),
                                  size=(dg.v_pad, dg.v_pad))
    one_source = dataclasses.replace(
        dg, csc_indices=torch.zeros_like(dg.csc_indices))
    ids = torch.from_numpy(np.sort(rng.choice(
        dg.v_pad, min(args.winners, dg.v_pad), replace=False))
        .astype(np.int32))
    buf = torch.zeros(dg.v_pad, dtype=torch.int32)
    buf[:ids.shape[0]] = ids
    buf = buf.to(dev)
    wins = torch.from_numpy(rng.random(dg.v_pad, dtype=np.float32)).to(dev)
    count = torch.tensor(ids.shape[0], dtype=torch.int32, device=dev)
    dense = torch.from_numpy(rng.random(dg.v_pad, dtype=np.float32)).to(dev)
    ids_k, wins_k = buf[:ids.shape[0]].long(), wins[:ids.shape[0]]
    hub = g.largest_degree_vertex()
    seed = torch.full((dg.v_pad,), float("inf"), device=dev)
    seed[hub] = 0.0
    mid, _ = P.pull_min_sweeps_plain(dg, seed, sweeps=3)
    n = dg.num_nodes
    dg_pr = to_device(g, with_csc=True, with_blocked_values=True,
                      device=args.device)
    rank0 = torch.where(torch.arange(dg.v_pad, device=dev) < n, 1.0 / n,
                        0.0)
    cases = (
        ("K3 pull_reduce2 sum/none", lambda: P.pull_reduce2(vals, dg)),
        ("torch.mv (sparse CSR)", lambda: torch.mv(csr, vals)),
        ("K3 sum/none, every source vertex 0",
         lambda: P.pull_reduce2(vals, one_source)),
        (f"K8 scatter_sorted min, {ids.shape[0]} winners of {dg.v_pad}",
         lambda: K.scatter_sorted(dense, buf, wins, count=count, op="min")),
        ("index_reduce_ amin, the same winners",
         lambda: dense.index_reduce_(0, ids_k, wins_k, "amin")),
        ("K4 pull_power_iters, 20 rounds",
         lambda: P.pull_power_iters(dg, rank0, iters=20, damping=0.85,
                                    reset=0.15 / n)),
        ("K4 pull_power_iters, 20 rounds at threshold 1e-6",
         lambda: P.pull_power_iters(dg, rank0, iters=20, damping=0.85,
                                    reset=0.15 / n, threshold=1e-6)),
        ("PageRank power route, pagerank's defaults",
         lambda: pagerank(dg_pr)),
        ("K6 pull_min_sweeps, 6 sweeps add/val from the hub",
         lambda: P.pull_min_sweeps(dg, seed, sweeps=6)),
        ("K6 pull_min_sweeps, the first sweep from the hub",
         lambda: P.pull_min_sweeps(dg, seed, sweeps=1)),
        ("K6 pull_min_sweeps, 3 sweeps after 3 plain ones",
         lambda: P.pull_min_sweeps(dg, mid, sweeps=3)),
        ("K9 brandes_levels, one source from the hub",
         lambda: brandes_source(dg, hub)),
    )
    pr = push_round(dg, hub)
    ex = pr["ex"]
    cases += (
        (f"K5 sample_sorted2 + sample_sorted, a push round's payload, "
         f"{ex.total} lanes",
         lambda: (K.sample_sorted2(dg.col_indices, dg.edge_values, ex.eid),
                  K.sample_sorted(pr["half"], ex.src))),
        (f"K7 reduce_by_dst_sorted min with aux, {pr['sd'].shape[0]} lanes",
         lambda: K.reduce_by_dst_sorted(pr["sd"], pr["cand"], op="min",
                                        out_lanes=pr["out_min"],
                                        aux=pr["aux"])),
        (f"K7 reduce_by_dst_sorted sum by source with the hub, "
         f"{pr['src'].shape[0]} lanes",
         lambda: K.reduce_by_dst_sorted(pr["src"], pr["add"], op="sum",
                                        out_lanes=pr["out_sum"])),
    )
    depths, fronts = pull_frontiers(dg, hub)
    cases += (
        (f"K1 pull_reached_words, pull levels {depths}",
         lambda: [K.pull_reached_words(w, dg) for w in fronts]),
        (f"K1 pull_reached_words, every source vertex 0, pull levels "
         f"{depths}",
         lambda: [K.pull_reached_words(w, one_source) for w in fronts]),
        (f"K10 bitmask_gather_cumsum, pull levels {depths}, "
         f"{dg.csc_indices.shape[0]} ids",
         lambda: [K.bitmask_gather_cumsum(w, dg.csc_indices)
                  for w in fronts]),
        (f"K10L1 bitmask_gather_cumsum, the mask through L1, pull levels "
         f"{depths}",
         lambda: [K._gather_cumsum(w, dg.csc_indices, False)
                  for w in fronts]),
    )
    cases += k2_cases(dg, hub, rng)
    if args.only:
        cases = tuple(c for c in cases
                      if any(word in c[0] for word in args.only))
    for name, fn in cases:
        host = host_ms(fn, args.reps, dev)
        call = call_ms(fn, args.reps, dev)
        call = "not measured" if call is None else f"{call:.4f} ms"
        r = profile_run(fn, args.reps, dev)
        print_profile("profile_pull", f"{name} (host {host:.4f} ms a call, "
                      f"call {call})", r)
        if name.startswith("K1") and r["device_ms"] > 0:
            print("[profile_pull]   a launch: " + "; ".join(
                f"{ev[:40]} {ms / calls:.4f} ms" for ev, calls, ms in
                r["events"]))
        if name.startswith("K4 pull_power_iters") and r["device_ms"] > 0:
            split = power_split(r, 20)
            print(f"[profile_pull]   K4 split: tile rows {split['build']:.4f}"
                  f" ms a call; pass 1 {split['pass1']:.4f} ms a round; the "
                  f"rest {split['rest']:.4f} ms a round")
    if dev.type == "cuda" and not args.only:
        # K8's host path in three cuts: the wrapper, its launch helper
        # with the arguments ready, and the C entry point alone.
        from ..ops import _build
        from ..ops.kernels import _launch
        lib = _build.load()
        kargs = (dense.data_ptr(), dense.shape[0], buf.data_ptr(),
                 wins.data_ptr(), buf.shape[0], count.data_ptr(), 0, 1, 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, fn in (
                ("K8 wrapper", lambda: K.scatter_sorted(
                    dense, buf, wins, count=count, op="min")),
                ("K8 _launch", lambda: _launch(lib.gr_scatter_sorted, *kargs,
                                               device=dev)),
                ("K8 C entry point", lambda: lib.gr_scatter_sorted(
                    *kargs, stream))):
            print(f"[profile_pull] host path, {name}: "
                  f"{host_ms(fn, args.reps, dev):.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
