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
   the kernels' launch counts reset just before and read just after; the
   graph is uploaded with the blocked CSC, so pulls run K1, and the
   small levels run the deep micro-loop.
   Labels are held against scipy's unweighted shortest paths,
   predecessors by validity, plus the structural checks of ``bench.py``.
4. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes, requiring exact equality, with median times from CUDA
   events: K1 at every level's frontier, K2 at the main path's launch
   (the largest-degree vertex's neighbours, sliced from ``col_indices``
   as the single-source push slices them) and at 2^22 random ids, each
   with its device time, and the device time of the mask's packing.
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
   within a relative tolerance; K3 bitwise equal over two launches; K4
   bitwise equal over two launches and to its composition from K3 (sum,
   ``mul``, ``wpr``, then the epilogue in torch), its change counts
   equal. Median times from CUDA events; for K3 sum/none, ``torch.mv``
   and K4 also the device time a call from ``torch.profiler``, K4's
   split into its tile rows (built once a call before its rounds), pass
   1 a round and the rest of a round.
10. Timing: best of 5 PageRank (both routes) and HITS runs after a
    warm-up: ms per iteration and MTEPS (num_edges x iterations, twice
    that for HITS, per ms).

11. SSSP, sweep route: the flagship with ``random_edge_values(seed=7)``,
    uploaded ``with_edge_values`` and ``with_blocked_values`` (which builds
    the CSC), ``sssp_device`` from the largest-degree vertex (bellman,
    which takes the min-pull sweeps, kernel K6). Distances within rtol
    1e-5 of scipy's float64 Dijkstra, the same unreachable set; the
    route and the sweep count are printed.
12. SSSP, push routes on the same graph: near-far with delta 32 x the
    mean weight, the same with ``fused=True`` (K7, K8), and
    ``gunrock_tpu_torch.sssp(g, mark_preds=True, device="cuda")`` on the
    host graph (bellman push). Distances bitwise equal to phase 11's,
    predecessors valid by exact float32 equality on an edge; K5 (and K3
    where a round pulled) launched in every run.
13. The grid of ``bench_all.py:225-263`` (1024 x 1024,
    ``random_edge_values(seed=1)``, ``with_blocked_values``): SSSP from 0
    with delta 256 (the sweep route bails out to near-far and its deep
    micro-loop), distances against scipy; non-DO BFS from 0 (sweeps, bail,
    then deep micro-loop stretches), labels against scipy's depths;
    non-DO BFS on the flagship (the sweep route converges), labels equal
    phase 3's.
14. K5-K8 against their plain versions at the shapes of the path's
    largest push round (K6 at 6 sweeps from the source, add, incr and
    none): exact, K7's sums within rtol 1e-6 and bitwise over two
    launches, also BC's backward sum by source over that frontier with
    the source vertex added, whose run spans many of K7's tiles. Median
    times; for K5, K7, K8 and ``index_reduce_`` also the device time a
    call. K6's tiles reduced and active edges a sweep, by its skip
    rule, and its bound over those edges beside the full-sweep one.
15. Timing, best of 5 after a warm-up: SSSP on the flagship (sweep route,
    near-far, near-far fused), SSSP on the grid, non-DO BFS on the grid.

16. BC, kernel-C route: ``gunrock_tpu_torch.bc`` on phase 11's graph
    (undirected, ``has_pull2``) from the largest-degree vertex, through
    kernel K9. Labels equal phase 3's, sigma within rtol 1e-4 and BC
    within rtol 1e-3, atol 1e-3 of the vectorised float64 oracle.
17. BC, the other routes on that graph (``GUNROCK_BC_PULL2=0``): the
    hybrid (K3 on the levels whose frontier edges pass E / 32, as many
    launches as the labels predict), the fused hybrid (K5, K7, K8) and
    the instrumented all-pull route (K3 a level), each against phase 16.
18. CC on the flagship uploaded ``with_edge_src`` and
    ``with_blocked_values``: components equal scipy's (minimum-id form)
    and their count; the branch of every round and K3's launches are
    printed. Then ``GUNROCK_CC_SWEEPS=1`` (K6), components equal.
19. K9 against its plain version at the flagship's shapes: every forward
    level in calls of 8, then every backward ring; labels and counts
    exact, sigma and delta within rtol 1e-5 of the float64-summing plain
    version, bitwise equal over two launches and to K9's composition from
    K3 (``pull_reduce2`` over the gated values, the epilogue in torch).
    Each level's tiles pass 1 reduces and active edges by K9's skip rules
    (csrc/pull_kernels.cu). Median times.
20. Timing, best of 5 after a warm-up: BC (kernel C, hybrid, fused), CC
    (hooking, sweeps) on the flagship; ms and MTEPS in ``bench_all.py``'s
    accounting (BC 2E, CC E, per ms).

21. The rest of BFS: DO-BFS with predecessors through ``bfs_device`` on
    the flagship uploaded ``with_csc`` only (no blocked CSC), so that
    every pull level runs kernel K10 once and K1 never; labels equal
    phase 3's, predecessors valid. Then the deep micro-loop: DO-BFS with
    predecessors on the grid from 0, every level a micro round (phase
    "deep"), labels against scipy's depths, predecessors valid.
22. K10 against its plain version, exactly, at the shapes of every pull
    level of phase 21 and at one length that is not a multiple of 128;
    median times, the bound, and ``torch.cumsum`` over precomputed hits
    as a reference for a later redesign.
23. Timing, best of 5 after a warm-up: DO-BFS on the flagship uploaded
    with the blocked CSC (K1; also with ``GUNROCK_BFS_DEEP=0``, where the
    tail level is a push) and without (K10); DO and non-DO BFS on the
    grid with the deep micro-loop and with ``GUNROCK_BFS_DEEP=0``.

24. Above the shared-memory cap: R-MAT scale 21, edge factor 4, whose
    frontier masks (65,536 words) are larger than K10 holds in shared
    memory, uploaded with the blocked CSC (K1) and without (K10): DO-BFS
    labels against scipy's depths, predecessors valid, and both kernels,
    which then read the mask through L1, exactly equal to their plain
    versions at every level's frontier.

25. WTF and TopK on the flagship at their defaults: ``gunrock_tpu_torch.wtf``
    from the largest-degree vertex on the host graph (uploaded
    ``with_csc``) and on phase 6's ``with_blocked_values`` graph, K3
    launched once a PPR iteration, PPR and the sorted scores within rtol
    1e-3, atol 1e-6 of ``cpu_wtf`` (the CLI's check) and within the
    limits set from the measured reading (PPR rtol 1e-5, the scores rtol
    1e-4, both with atol 0), the two runs' PPR bitwise equal and
    their node ids equal where the scores stand apart; the PPR iteration
    count, the CoT's out-edge count, best of 5 and ms a PPR iteration.
    ``gunrock_tpu_torch.topk`` at k = 10 and 1000, exact against numpy's
    degrees, best of 5.

26. TC on the flagship through ``gunrock_tpu_torch.tc`` (the sort-join of
    ``ops/intersection.py``, PyTorch operators, no kernel of its own):
    the chunk count equals ``_tc_prepare``'s, the per-edge counts sum to
    the total and the per-vertex counts to three times it, and 100,000
    oriented edges drawn by a seeded generator each count
    ``np.intersect1d`` of their two DAG rows. Exact against ``cpu_tc`` on
    R-MAT scale 14, edge factor 16, in one chunk and, with
    ``GUNROCK_TC_WEDGE_BUDGET=2**20``, in several with equal counts;
    ``python -m gunrock_tpu_torch tc rmat --rmat_scale=12 --undirected``
    prints CORRECT. ``gunrock_tpu_torch.sample`` from the hub equals phase
    3's labels; ``expand_inverse`` of the hub, ``cull_filter`` of its
    lanes and ``pull_reduce`` sum/max/min on the flagship equal the same
    functions with ``device="cpu"`` (sums rtol 1e-6). TC best of 5
    ``process_ms`` after a warm-up, a chunk's share and wedges per
    microsecond; the device time of the first 5 chunks by step
    (expansion, sort, run flag and gather, scatters) and the busy share of
    a whole run, from ``torch.profiler``.
27. SSSP's value-carry micro-loop (``deep_carry=True``): the flagship
    with phase 12's near-far delta and the grid of phase 13 (delta 256,
    through the sweeps' bail-out), distances bitwise equal to the
    ``deep_carry=False`` runs, rounds and edge counts equal, and K5's pair
    mode launched once a carry round (``sample_sorted`` fewer times than
    without carry); the grid with and without carry, best of 3 each, in
    turns.

28. 64-bit offsets: the flagship (phase 11's weights) uploaded
    ``with_csc, with_edge_values, with_edge_src`` with ``sizet64=True``
    (int64 offsets checked) and with int32 offsets. DO-BFS with
    predecessors (K10, K2), SSSP near-far and fused (K5, K7, K8), CC,
    PageRank's loop route (K3 over the narrowed row bounds) and BC,
    hybrid and fused (K5, K7, K8), on both uploads: every result bitwise
    equal, or, where two runs on the int32 upload differ too (atomic
    sums), within section 2's tolerance of ``PERF.md``. DO-BFS best of 5
    on both uploads, in turns.
29. A graph past 2^31 edges: the circulant C(2^16; 1..2^14) (every
    vertex joined to the 2^14 on each side on the ring: 2^31 edges,
    degree 32,768), built in numpy without a sort (its CSC is its CSR)
    and handed to ``from_numpy``, whose rule picks int64 offsets by
    itself. DO-BFS with predecessors from 0 through ``gtt.bfs``: one
    push level, then pulls through K10 over all 2^31 CSC ids; labels
    equal ceil(d / h) (d the ring distance), every predecessor within
    ring distance h and one level up. K10 at the depth-1 mask and at
    the all-vertices mask (whose last sum wraps to -2^31) bitwise equal
    to its plain version, compared in chunks that carry the plain
    running sum. Prints the host's memory (``free -g``), the host build,
    ``from_numpy``'s checks and upload, peak device memory of the upload
    and of the traversal, the traversal's wall and process times by
    level, and the card.
30. The C ABI and ``rmat_device``: builds the port's C shim
    (``gunrock_tpu_torch.capi.build_capi_lib``), compiles
    ``examples/capi_example_torch.c`` against it with gcc and runs it on
    the 7-vertex graph of ``tests/test_capi.py`` (CC, BFS, SSSP,
    PageRank and BC, checked by the C program), then its BFS on the
    flagship through raw int32 files: labels equal phase 3's. Then
    ``gtt.io.rmat_device(20, 32)`` on the card: ids in range, edge
    count, degree statistics and quadrant shares beside the host
    generator's COO, the shares within 0.005.

31. The sharded zoo (``gunrock_tpu_torch.parallel``) on a shard mesh of
    4 shards of the card: the flagship (phase 11's weights) partitioned
    once, ``random``, with the CSC, the ghost tables and the weights (its
    seconds printed), then the ``*_device`` entry points on that one
    partition: DO-BFS with predecessors through K1 (once a shard a pull
    superstep) and non-DO BFS, labels equal phase 3's, predecessors
    valid; PageRank, 20 iterations at threshold 0 through K3 sum/``mul``
    once a shard an iteration, within rtol 1e-4 of the single card's loop
    route; SSSP near-far with the pull-relax through K3 min/``add``,
    distances bitwise equal phase 11's; CC equal to the single card's;
    BC from the hub (labels equal, sigma rtol 1e-4, BC rtol 1e-3, atol
    1e-3), HITS and SALSA (phase 8's tolerances) against the single
    card; ``bfs_batch`` of 4 sources (the hub's row equal phase 3's).
    Each run's process time, supersteps, ``comm_bytes`` and launches;
    K1 on every shard view at the pull levels and K3 (min/``add``
    bitwise, sum/``mul`` within rel 1e-5) on every compact table against
    their plain versions, with median times and bounds. Then on R-MAT
    scale 16: ``wtf_sharded`` (PPR and sorted scores within the CLI's
    rtol 1e-3, atol 1e-6 of the single card), ``topk_sharded`` (exact
    against numpy's degrees), ``tc_sharded`` (equal to the single
    card), and the seven partition methods, each partition's seconds and
    boundary fraction and its DO-BFS through K1 equal to the single
    card's labels.

Each phase's kernel launch counts are reset just before it and read just
after; the ``launches`` of the JSON line come from phases 3 (K1, K2), 6
(K4), 7-8, 17, 25 and 28 (K3), 12, 17, 27 and 28 (K5), 12, 17 and 28
(K7, K8), 11 (K6), 16 (K9), 21, 28 and 29 (K10), 28 (K2) and 31 (every
kernel a sharded run launched: K1, K3, and K2 in ``bfs_batch``). K1's
entry also carries ``shard_*`` (K1 on the shard views at the sharded
DO-BFS's pull levels, summed over the levels and shards) and K3's
``compact_*`` (K3 on the shards' compact tables, summed over the
shards). Every kernel's entry also carries
``bound_ms``, the least time the card could take for the same work at
the H100's published rates (see
:func:`bound`), and ``library_ms``, the time of one PyTorch call that
computes the same function on the same inputs where there is one: the
CSR sparse matrix-vector product for K3 (phase 9), ``index_select`` for
K5 and ``index_reduce_`` for K8 (phase 14); the port calls none of them.
The ``ms`` of every kernel is the CUDA-event time of a call, host path
included where the card waits on it; K3 and K8 also carry ``device_ms``
and ``library_device_ms``, the device time of a call of the kernel and
of its library call (:func:`_device_ms`), K2 its ``device_ms`` at the
main path's launch (whose shape its row gives, ``ids``) and, under
``random_*``, all its numbers at 2^22 random ids, with
``pack_device_ms``, the device time of the mask's packing; K1 and K10
their ``device_ms`` summed over the pull levels, K4 its ``device_ms`` and
``build_device_ms``, the device time of its tile rows a call, K5 the
device time of a round's pair and K7 that of its min with aux and
(``ring_device_ms``) of BC's ring sum. A device time that the profiler
does not record fails the run (:func:`_profile`).

The last two lines are a JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
from unittest.mock import patch

SCALE, EDGE_FACTOR, SEED = 20, 32, 1
RUNS = 5
TIMED_LAUNCHES = 20
BFS_KERNELS = ("pull_reached_words", "bitmask_gather")
K10_ODD_LENGTH = 1_000_003      # a K10 length that is not a multiple of 128
PR_ITERS, LINK_ITERS = 20, 10
SSSP_WEIGHT_SEED, GRID_SIDE, GRID_WEIGHT_SEED, GRID_DELTA = 7, 1024, 1, 256.0
SWEEPS = 6
BC_LEVELS = 8
# Published H100 SXM rates (NVIDIA data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_RATE, FP32_RATE = 3.35e12, 67e12


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its float32 operations over the peak rate. A kernel whose rounds
    each read the whole graph (K4) is counted a round at a time, as its
    plain version and a library call would run them; K6's sweeps only
    need the edges of their active sources, and K9's levels those of one
    depth each, so a K9 phase counts the reached edges once. Integer and
    bit operations are left out (at most one per 4 bytes moved)."""
    b_ms = nbytes / HBM_RATE * 1e3
    o_ms = flops / FP32_RATE * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def pull_bytes(num_edges: int, v_pad: int, vectors: int,
               edge_streams: int = 1) -> int:
    """Bytes of one pull over the CSC: ``edge_streams`` int32 or float32
    arrays of one entry an edge (csc_indices, and the weights where read;
    the row of each edge follows from csc_offsets) and ``vectors``
    (v_pad,) arrays read or written (the values, the offsets, the
    output, ...)."""
    return 4 * edge_streams * num_edges + 4 * vectors * v_pad


def num_tiles(dg) -> int:
    from gunrock_tpu_torch.ops.pull2 import PULL_TILE
    return -(-dg.num_edges // PULL_TILE)


def tile_activity(dg, active, live_rows=None) -> tuple[int, int, int]:
    """(tiles pass 1 reduces, live tiles, active edges) of a gated pull,
    by the rules of csrc/pull_kernels.cu: an edge is active when its
    source's group (``group_size(v_pad)`` consecutive vertices) holds a
    vertex of ``active``; with ``live_rows`` (K9) a tile is live when it
    holds an edge into one of them (else it is skipped before its loads),
    without every tile is; a live tile is reduced when it holds an active
    edge; the active edges counted lie in live tiles."""
    import torch
    from gunrock_tpu_torch.ops.pull2 import PULL_TILE, group_size
    e, n = dg.num_edges, num_tiles(dg)
    group = torch.arange(dg.v_pad, device=active.device) // group_size(
        dg.v_pad)
    hit = torch.zeros(int(group[-1]) + 1, dtype=torch.bool,
                      device=active.device)
    hit[group[active]] = True
    active = hit[group]

    def per_tile(edge_flags):
        padded = torch.zeros(n * PULL_TILE, dtype=torch.bool,
                             device=edge_flags.device)
        padded[:e] = edge_flags
        return padded.view(n, PULL_TILE).any(1)

    on = active[dg.csc_indices[:e].long()]
    live = n
    if live_rows is not None:
        deg = dg.csc_offsets[1:] - dg.csc_offsets[:-1]
        tile_live = per_tile(torch.repeat_interleave(live_rows, deg,
                                                     output_size=e))
        live = int(tile_live.sum())
        on &= tile_live.repeat_interleave(PULL_TILE)[:e]
    return int(per_tile(on).sum()), live, int(on.sum())


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


def _profile(fn, reps: int = TIMED_LAUNCHES) -> dict:
    """``torch.profiler``'s record of ``reps`` calls of ``fn`` after a
    warm-up (the port's ``tools.profile_value.profile_run``, which takes
    the profile again where device events were lost and raises where
    none of its attempts is whole), so the run fails rather than carry a
    row without its device time."""
    import torch
    from gunrock_tpu_torch.tools.profile_value import profile_run
    return profile_run(fn, reps, torch.device("cuda"))


def _device_ms(fn, reps: int = TIMED_LAUNCHES) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    device events (kernels, copies, fills) of :func:`_profile`, over
    ``reps``."""
    return _profile(fn, reps)["device_ms"]


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
    share = float(err.sum() / max(float(np.abs(want).sum()), 1e-30))
    print(f"[check] {what}: max abs err {float(err.max()):.3e}, max rel err "
          f"{rel:.3e}, sum|err|/sum|ref| {share:.3e} (rtol {rtol}, atol "
          f"{atol}), {bad} outside")
    if bad:
        raise AssertionError(f"{what}: {bad} values outside the tolerance")


def _errs(got, want) -> tuple[float, float]:
    """(max abs, max rel) error of a float tensor against its reference;
    equal entries (0 or inf on both sides) count 0."""
    import torch
    err = torch.where(got == want, 0.0, (got.double() - want.double()).abs())
    rel = err / want.double().abs().clamp(min=1e-30)
    return float(err.max()), float(rel.max())


def _apart(scores, rtol: float = 1e-5):
    """Ranks whose score differs from both neighbours' in the ranking by
    more than ``rtol`` of itself: there the order cannot depend on float
    summation order."""
    import numpy as np
    s = np.asarray(scores, np.float64)
    gap = np.full(s.shape[0] + 1, np.inf)
    gap[1:-1] = np.abs(np.diff(s))
    return np.minimum(gap[:-1], gap[1:]) > rtol * np.abs(s)


def phase_wtf_topk(gtt, g, src, dgv, card):
    """Phase 25: WTF and TopK on the flagship at their defaults. WTF from
    the largest-degree vertex through ``gtt.wtf`` on the host graph
    (uploaded ``with_csc``) and on phase 6's ``with_blocked_values``
    graph: K3 launched once a PPR iteration, PPR and the sorted scores
    within rtol 1e-3, atol 1e-6 of ``cpu_wtf`` (float64), as the CLI
    checks them, and within PPR rtol 1e-5 and the scores' rtol 1e-4 with
    no atol (the measured reading: a typical PPR entry is near 1/V, under
    the CLI's atol), the two runs' PPR bitwise equal and their node ids equal at every rank whose score
    stands apart (:func:`_apart`; the SALSA sums are atomics). TopK at
    k = 10 and 1000, exact against numpy's degrees with the id-ascending
    tie rule. Best of RUNS after a warm-up. Returns the K3 launches."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.models.topk import top_k, topk_device
    from gunrock_tpu_torch.models.wtf import _ppr, wtf_device
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.utils.reference import cpu_wtf

    t0 = time.perf_counter()
    ref, ppr_ref = cpu_wtf(g, src)
    print(f"[wtf] float64 oracle {time.perf_counter() - t0:.3f} s")
    runs, k3 = {}, 0
    for name, graph in (("host graph", g), ("blocked-values graph", dgv)):
        K.reset_launch_counts()
        res = gtt.wtf(graph, src, device="cuda")
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        iters = res.info["ppr_iterations"]
        print(f"[wtf] {name}: ppr_iterations {iters}, process "
              f"{res.info['process_ms']:.3f} ms, kernel launches {launches}")
        if launches.pop("pull_reduce2") != iters or any(launches.values()):
            raise AssertionError(f"WTF on the {name}: K3 should launch once "
                                 f"a PPR iteration and nothing else")
        # The CLI's tolerance, then limits from the measured reading:
        # most PPR entries lie near 1/V, under the CLI's atol.
        k = res.scores.shape[0]
        scores = np.sort(res.scores)[::-1]
        want = np.sort(ref)[::-1][:k]
        for rtol, atol, tight in ((1e-3, 1e-6, ""), (1e-5, 0.0, " (tight)")):
            check_close(f"wtf {name} ppr vs cpu_wtf{tight}", res.ppr_ranks,
                        ppr_ref, rtol=rtol, atol=atol)
        for rtol, atol, tight in ((1e-3, 1e-6, ""), (1e-4, 0.0, " (tight)")):
            check_close(f"wtf {name} sorted scores vs cpu_wtf{tight}",
                        scores, want, rtol=rtol, atol=atol)
        runs[name] = res
        k3 += iters
    a, b = runs.values()
    keep = _apart(a.scores) & _apart(b.scores)
    if not (np.array_equal(a.ppr_ranks, b.ppr_ranks) and
            np.array_equal(a.node_ids[keep], b.node_ids[keep])):
        raise AssertionError("the two WTF runs differ")
    ppr = torch.from_numpy(a.ppr_ranks).to(dgv.device)
    _, cot = top_k(ppr, a.scores.shape[0])
    cot_edges = int(dgv.out_degrees()[cot.long()].sum())
    print(f"[wtf] the two runs: PPR bitwise equal, node ids equal at "
          f"{int(keep.sum())} of {keep.shape[0]} ranks whose scores stand "
          f"apart; the CoT's out-edges (the expand) {cot_edges}")
    best, times = best_of(lambda: wtf_device(dgv, src))
    iters = a.info["ppr_iterations"]
    ppr_best, _ = best_of(lambda: _ppr(dgv, src, delta=0.85, max_iters=50,
                                       threshold=1e-6))
    print(f"[timing] wtf (blocked-values graph): best {best:.3f} ms of "
          f"{RUNS} ({', '.join(f'{t:.3f}' for t in times)}); PPR alone "
          f"{ppr_best:.3f} ms, {ppr_best / iters:.4f} ms a PPR iteration "
          f"({iters}); on {card}")

    cent = g.out_degrees + np.bincount(g.col_indices, minlength=g.num_nodes)
    for k in (10, 1000):
        res = gtt.topk(dgv, k)
        order = np.argsort(-cent, kind="stable")[:k]
        if not (np.array_equal(res.node_ids, order) and
                np.array_equal(res.centralities, cent[order])):
            raise AssertionError(f"TopK k={k} differs from numpy's degrees")
        best, times = best_of(lambda: topk_device(dgv, k))
        print(f"[topk] k={k}: ids and centralities equal numpy's (largest "
              f"{int(cent[order[0]])}, k-th {int(cent[order[-1]])}); best "
              f"{best:.3f} ms of {RUNS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); on {card}")
    return k3


def phase_k2_kernel(dg, src, labels, rng, dev):
    """Phase 4's K2 cases: against its plain version, exactly, at the
    main path's launch (the largest-degree vertex's neighbours, sliced
    from col_indices as the single-source push slices them, over the
    mask of the first level: every vertex but the source unvisited) and
    at 2^22 random ids over the traversal's final unvisited mask; the
    time a call (CUDA events), its device time (torch.profiler) and the
    bound of each, and the device time of the mask's packing, which runs
    before every K2 launch. Returns K2's JSON fields: those of the main
    path's launch, and the same of 2^22 ids under ``random_*``."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import kernels as K

    start, end = dg.row_offsets[src:src + 2].tolist()
    first = torch.full((dg.v_pad,), -1, dtype=torch.int32, device=dev)
    first[src] = 0
    cases = {
        "main path": (K.pack_bitmask(first == -1), dg.col_indices[start:end]),
        "random": (K.pack_bitmask(labels == -1), torch.from_numpy(
            rng.integers(0, dg.v_pad, 1 << 22).astype(np.int32)).to(dev)),
    }
    out = {}
    for name, (words, idx) in cases.items():
        got = K.bitmask_gather(words, idx)
        want = K.bitmask_gather_plain(words, idx)
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from its plain version at "
                                 f"{name}")
        row = {"ids": idx.shape[0], "max_abs_err": _max_abs_err(got, want),
               "ms": _median_ms(lambda: K.bitmask_gather(words, idx)),
               "plain_ms": _median_ms(
                   lambda: K.bitmask_gather_plain(words, idx)),
               "device_ms": _device_ms(lambda: K.bitmask_gather(words, idx)),
               "library_ms": None,
               # the ids, the output and the mask
               **bound(8 * idx.shape[0] + dg.v_pad // 8)}
        print(f"[kernels] K2 bitmask_gather {name}, {idx.shape[0]} ids "
              f"(offset {idx.data_ptr() % 16} bytes mod 16): equal, "
              f"{row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms; device "
              f"{row['device_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms")
        out[name] = row
    pack_ms = _device_ms(lambda: K.pack_bitmask(labels == -1))
    print(f"[kernels] pack_bitmask(labels == INVALID) before each K2 "
          f"launch: device {pack_ms:.4f} ms")
    return {**out["main path"], "pack_device_ms": pack_ms,
            **{f"random_{k}": v for k, v in out["random"].items()
               if k not in ("library_ms", "bound_by")}}


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
    their plain versions at the flagship's shapes, K4 also against its
    composition from K3. Returns the JSON fields of both."""
    import dataclasses
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import pull2 as P
    from gunrock_tpu_torch.tools.profile_pull import power_split
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
            k3.update(bound(pull_bytes(dg.num_edges, dg.v_pad, 3),
                            dg.num_edges))
            # The yardstick: cuSPARSE's CSR matrix-vector product over the
            # same CSC (row v lists the in-neighbours of v), built here.
            e = dg.num_edges
            csr = torch.sparse_csr_tensor(
                dg.csc_offsets, dg.csc_indices[:e],
                torch.ones(e, device=dev), size=(dg.v_pad, dg.v_pad))
            lib_abs, lib_rel = _errs(torch.mv(csr, vals), want)
            k3["library_ms"] = _median_ms(lambda: torch.mv(csr, vals))
            k3["device_ms"] = _device_ms(lambda: P.pull_reduce2(vals, dgv,
                                                                **kw))
            k3["library_device_ms"] = _device_ms(lambda: torch.mv(csr, vals))
            print(f"[kernels] K3 yardstick torch.mv(sparse CSR): "
                  f"{k3['library_ms']:.4f} ms, max rel err {lib_rel:.3e} "
                  f"vs the plain version; bound {k3['bound_ms']:.4f} ms")
            print(f"[kernels] K3 sum/none device time (torch.profiler): "
                  f"{k3['device_ms']:.4f} ms a call vs torch.mv "
                  f"{k3['library_device_ms']:.4f} ms")
            del csr
    n = dg.num_nodes
    start = torch.where(torch.arange(dg.v_pad, device=dev) < n, 1.0 / n,
                        0.0).float()
    kw = dict(damping=0.85, reset=0.15 / n, threshold=1e-6)
    vmask = torch.arange(dg.v_pad, device=dev) < n
    d32 = torch.tensor(kw["damping"], dtype=torch.float32, device=dev)
    r32 = torch.tensor(kw["reset"], dtype=torch.float32, device=dev)

    def k3_rounds(rank, iters):
        """K4's rounds composed from K3 sum/mul/wpr and the epilogue in
        torch, which K4 equals bit for bit."""
        chg = []
        for _ in range(iters):
            acc = P.pull_reduce2(rank, dg, op="sum", wmode="mul",
                                 weights="wpr")
            fresh = torch.where(vmask, r32 + d32 * acc, 0.0)
            chg.append(((fresh - rank).abs() > kw["threshold"]).sum())
            rank = fresh
        return rank, torch.stack(chg).to(torch.int32)

    k4 = {}
    for iters, rtol in ((1, 1e-5), (PR_ITERS, 1e-3)):
        rank, chg = P.pull_power_iters(dg, start, iters=iters, **kw)
        again, again_chg = P.pull_power_iters(dg, start, iters=iters, **kw)
        composed, composed_chg = k3_rounds(start, iters)
        want, want_chg = P.pull_power_iters_plain(dg, start, iters=iters,
                                                  **kw)
        torch.cuda.synchronize()
        if not (torch.equal(rank, again) and torch.equal(chg, again_chg)):
            raise AssertionError(f"K4 {iters} rounds: two launches differ")
        if not (torch.equal(rank, composed)
                and torch.equal(chg, composed_chg)):
            raise AssertionError(f"K4 {iters} rounds differ from their "
                                 f"composition from K3")
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
        prof = _profile(lambda: P.pull_power_iters(dg, start, iters=iters,
                                                   **kw))
        device = prof["device_ms"]
        split = power_split(prof, iters)
        print(f"[kernels] K4 pull_power_iters {iters} rounds: bitwise equal "
              f"over two launches and to K3's composition; max abs err "
              f"{abs_err:.3e}, max rel err {rel_err:.3e} (rtol {rtol}); "
              f"change counts equal {chg.tolist()}; {ms:.4f} ms vs plain "
              f"{plain:.4f} ms; device {device:.4f} ms: tile rows "
              f"{split['build']:.4f} ms a call apart from the rounds, pass 1 "
              f"{split['pass1']:.4f} and the rest {split['rest']:.4f} ms a "
              f"round")
        k4 = {"max_abs_err": max(k4.get("max_abs_err", 0.0), abs_err),
              "max_rel_err": max(k4.get("max_rel_err", 0.0), rel_err),
              "ms": ms, "plain_ms": plain, "device_ms": device,
              "build_device_ms": split["build"], "library_ms": None,
              # a round: rank, 1/out-degree, offsets and output vectors
              **bound(iters * pull_bytes(dg.num_edges, dg.v_pad, 4),
                      iters * (dg.num_edges + 3 * dg.v_pad))}
    return k3, k4


def phase_value_timing(dg, card):
    """Phase 10: best of RUNS PageRank (both routes) and HITS runs after a
    warm-up, graph on the card, fenced with torch.cuda.synchronize()."""
    from gunrock_tpu_torch.models.hits import hits_device
    from gunrock_tpu_torch.models.pr import pagerank_device

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


def best_of(fn):
    """Best of RUNS calls of ``fn`` after a warm-up, fenced; (best, all)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), times


def dijkstra(g, src):
    """scipy's float64 Dijkstra over the CSR, parallel edges reduced to
    the lightest."""
    import numpy as np
    import scipy.sparse
    from scipy.sparse.csgraph import dijkstra as sp_dijkstra
    es = g.edge_sources().astype(np.int64)
    key = es * g.num_nodes + g.col_indices
    order = np.lexsort((g.edge_values, key))
    key, w = key[order], g.edge_values[order].astype(np.float64)
    first = np.r_[True, key[1:] != key[:-1]]
    a = scipy.sparse.csr_matrix(
        (w[first], (key[first] // g.num_nodes, key[first] % g.num_nodes)),
        shape=(g.num_nodes, g.num_nodes))
    return sp_dijkstra(a, directed=True, indices=src)


def check_dist(what, dist, ref):
    """Same unreachable set as scipy, finite distances within rtol 1e-5."""
    import numpy as np
    fin = np.isfinite(ref)
    if not np.array_equal(np.isfinite(dist), fin):
        raise AssertionError(f"{what}: the reached set differs from scipy's")
    check_close(what, dist[fin], ref[fin], rtol=1e-5, atol=0.0)


def check_sssp_preds(g, src, dist, preds):
    """pred[v] = u has an edge (u, v) with float32 dist[u] + w == dist[v];
    -1 exactly at the source, at distance 0 and where unreached."""
    import numpy as np
    none = ~np.isfinite(dist) | (dist == 0)
    if (preds[none] != -1).any() or (preds[~none] < 0).any():
        raise AssertionError("a predecessor is set where it should not be, "
                             "or missing")
    v = np.nonzero(~none)[0]
    p = preds[v].astype(np.int64)
    keys = g.edge_sources().astype(np.int64) * g.num_nodes + g.col_indices
    q = p * g.num_nodes + v
    at = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    if (keys[at] != q).any():
        raise AssertionError("a predecessor is not an in-neighbour")
    if (dist[p] + g.edge_values[at] != dist[v]).any():
        raise AssertionError("dist[pred] + w != dist[v] on a tree edge")


def phase_sssp(gtt, g, src, dev, card):
    """Phases 11 and 12: SSSP on the flagship, the sweep route and the
    push routes. Returns the uploaded graph, the sweep route's distances
    and the main-path launch counts of K3, K5, K6, K7 and K8."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.models.sssp import sssp_device
    from gunrock_tpu_torch.ops import kernels as K

    # 11. The sweep route.
    g.random_edge_values(seed=SSSP_WEIGHT_SEED)
    t0 = time.perf_counter()
    dg = gtt.to_device(g, with_edge_values=True, with_blocked_values=True,
                       device=dev)
    torch.cuda.synchronize()
    print(f"[sssp] to_device(with_edge_values, with_blocked_values) "
          f"{time.perf_counter() - t0:.3f} s; has_csc {dg.has_csc}, "
          f"has_pull2 {dg.has_pull2}")
    K.reset_launch_counts()
    dist_t, _, stats = sssp_device(dg, src)
    torch.cuda.synchronize()
    sweep_launches = dict(K.LAUNCHES)
    print(f"[sssp] sweep route: route {stats.route}, {stats.iteration} "
          f"iterations; changes per sweep {stats.frontier_trace}; kernel "
          f"launches {sweep_launches}")
    if sweep_launches["pull_min_sweeps"] <= 0:
        raise AssertionError("K6 was not launched on the sweep route")
    dist = dist_t[:g.num_nodes].cpu().numpy()
    t0 = time.perf_counter()
    ref = dijkstra(g, src)
    print(f"[sssp] scipy Dijkstra {time.perf_counter() - t0:.3f} s; "
          f"{int(np.isfinite(ref).sum())} reached")
    check_dist("sssp sweep route vs scipy", dist, ref)

    # 12. The push routes on the same graph.
    delta = 32.0 * float(np.mean(g.edge_values))
    launches = {}
    for name, kw in (("near-far", dict(mode="nearfar", delta=delta)),
                     ("near-far fused", dict(mode="nearfar", delta=delta,
                                             fused=True))):
        K.reset_launch_counts()
        records = []
        got, _, st = sssp_device(dg, src, instrument=records, **kw)
        torch.cuda.synchronize()
        n = dict(K.LAUNCHES)
        phases = [r["phase"] for r in records]
        print(f"[sssp] {name}: route {st.route}, {st.iteration} rounds "
              f"({', '.join(f'{p} {phases.count(p)}' for p in sorted(set(phases)))}); "
              f"kernel launches {n}")
        if not torch.equal(got, dist_t):
            raise AssertionError(f"sssp {name}: distances differ from the "
                                 "sweep route's")
        if n["sample_sorted"] <= 0 or n["sample_sorted2"] <= 0:
            raise AssertionError(f"K5 was not launched by {name}")
        if ("pull" in phases) != (n["pull_reduce2"] > 0):
            raise AssertionError(f"{name}: K3 launches do not match the "
                                 "pull rounds")
        if kw.get("fused") and (n["reduce_by_dst_sorted"] <= 0
                                or n["scatter_sorted"] <= 0):
            raise AssertionError("K7 or K8 was not launched by the fused "
                                 "run")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    K.reset_launch_counts()
    res = gtt.sssp(g, src, mark_preds=True, device="cuda")
    torch.cuda.synchronize()
    n = dict(K.LAUNCHES)
    print(f"[sssp] host graph, sssp(g, mark_preds=True, device='cuda'): "
          f"route {res.info['route']}, {res.info['num_iterations']} rounds, "
          f"preprocess {res.info['preprocess_ms']:.3f} ms, process "
          f"{res.info['process_ms']:.3f} ms; kernel launches {n}")
    if not np.array_equal(res.distances, dist):
        raise AssertionError("sssp on the host graph: distances differ from "
                             "the sweep route's")
    if n["sample_sorted"] <= 0 or n["sample_sorted2"] <= 0:
        raise AssertionError("K5 was not launched on the host graph")
    check_sssp_preds(g, src, res.distances, res.preds)
    for k, v in n.items():
        launches[k] = launches.get(k, 0) + v
    launches["pull_min_sweeps"] = sweep_launches["pull_min_sweeps"]
    print("[sssp] distances bitwise equal over the sweep, near-far, fused "
          "and bellman-push routes; preds valid")
    return dg, dist_t, launches


def phase_grid(gtt, g, src, dg, bfs_labels, dev):
    """Phase 13: the grid's SSSP and non-DO BFS, then non-DO BFS on the
    flagship. Returns the grid graphs."""
    import numpy as np
    import torch
    from scipy.sparse.csgraph import shortest_path
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.models.sssp import sssp_device
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.tools.profile_sssp import grid

    t0 = time.perf_counter()
    gg = grid(GRID_SIDE)
    gg.random_edge_values(seed=GRID_WEIGHT_SEED)
    dgw = gtt.to_device(gg, with_edge_values=True, with_blocked_values=True,
                        device=dev)
    torch.cuda.synchronize()
    print(f"[grid] {GRID_SIDE}x{GRID_SIDE}: |V|={gg.num_nodes} "
          f"|E|={gg.num_edges}, build and upload "
          f"{time.perf_counter() - t0:.3f} s; has_pull2 {dgw.has_pull2}")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dist, _, st = sssp_device(dgw, 0, mode="pull", delta=GRID_DELTA)
    torch.cuda.synchronize()
    print(f"[grid] sssp mode=pull delta {GRID_DELTA}: route {st.route}, "
          f"{st.iteration} rounds, {(time.perf_counter() - t0) * 1e3:.3f} "
          f"ms; kernel launches {dict(K.LAUNCHES)}")
    if st.route != "bailed_to_nearfar":
        raise AssertionError("the grid's sweep route should bail out")
    check_dist("grid sssp vs scipy", dist[:gg.num_nodes].cpu().numpy(),
               dijkstra(gg, 0))
    K.reset_launch_counts()
    labels, _, st = bfs_device(dgw, 0)
    torch.cuda.synchronize()
    print(f"[grid] non-DO bfs: route {st.route}, {st.iteration} levels in "
          f"{st.deep_stretches} deep micro-loop stretches; kernel launches "
          f"{dict(K.LAUNCHES)}")
    if st.route != "bailed_to_push":
        raise AssertionError("the grid's BFS sweep route should bail out")
    if st.deep_stretches <= 0:
        raise AssertionError("the grid's BFS ran no deep micro-loop stretch")
    check_labels(gg, 0, labels[:gg.num_nodes].cpu().numpy())
    K.reset_launch_counts()
    labels, _, st = bfs_device(dg, src)
    torch.cuda.synchronize()
    print(f"[grid] non-DO bfs on the flagship: route {st.route}, "
          f"{st.iteration} sweeps; kernel launches {dict(K.LAUNCHES)}")
    if st.route != "pull_sweeps":
        raise AssertionError("the flagship's BFS sweep route should converge")
    if not np.array_equal(labels[:g.num_nodes].cpu().numpy(), bfs_labels):
        raise AssertionError("non-DO BFS labels differ from phase 3's")
    print("[grid] distances and labels equal scipy's; flagship labels equal "
          "phase 3's")
    return gg, dgw


def phase_sssp_kernels(dg, src, dist, dev):
    """Phase 14: K5-K8 against their plain versions at the shapes of the
    largest push round the flagship's path runs (a frontier whose edge
    volume is just under E / 16, sorted), and K6 at 6 sweeps from the
    source. Returns each kernel's JSON fields."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.ops import pull2 as P
    from gunrock_tpu_torch.ops.advance import expand

    rng = np.random.default_rng(SEED)
    deg = (dg.row_offsets[1:] - dg.row_offsets[:-1]).long()
    perm = torch.from_numpy(rng.permutation(dg.num_nodes)).to(dev)
    take = torch.cumsum(deg[perm], 0) <= dg.num_edges // 16
    frontier = torch.sort(perm[take]).values.to(torch.int32)
    ex = expand(dg, frontier, with_dst=False)
    # A mid-traversal state: half the vertices not reached yet.
    half = torch.where(torch.from_numpy(rng.random(dg.v_pad) < 0.5).to(dev),
                       float("inf"), dist)
    out = {}

    def report(name, err, ms, plain, note, work, library=None):
        lib = "" if library is None else f", library {library:.4f} ms"
        print(f"[kernels] {name}: {note}; max abs err {err}; {ms:.4f} ms vs "
              f"plain {plain:.4f} ms{lib}; bound {work['bound_ms']:.4f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "library_ms": library, **work}

    # K5, the payload of the round: two arrays at eid, one at src.
    two = K.sample_sorted2(dg.col_indices, dg.edge_values, ex.eid)
    one = K.sample_sorted(half, ex.src)
    want2 = K.sample_sorted2_plain(dg.col_indices, dg.edge_values, ex.eid)
    want1 = K.sample_sorted_plain(half, ex.src)
    torch.cuda.synchronize()
    if not (torch.equal(two[0], want2[0]) and torch.equal(two[1], want2[1])
            and torch.equal(one, want1)):
        raise AssertionError("K5 differs from its plain version")
    report("sample_sorted", 0.0,
           _median_ms(lambda: K.sample_sorted2(dg.col_indices,
                                               dg.edge_values, ex.eid))
           + _median_ms(lambda: K.sample_sorted(half, ex.src)),
           _median_ms(lambda: K.sample_sorted2_plain(
               dg.col_indices, dg.edge_values, ex.eid))
           + _median_ms(lambda: K.sample_sorted_plain(half, ex.src)),
           f"{ex.total} lanes, both modes exact (time: one round's pair)",
           # eid, two gathered values and two outputs a lane; src, one
           # output and the frontier's distances
           bound(32 * ex.total + 4 * frontier.shape[0]),
           _median_ms(lambda: dg.col_indices.index_select(0, ex.eid))
           + _median_ms(lambda: dg.edge_values.index_select(0, ex.eid))
           + _median_ms(lambda: half.index_select(0, ex.src)))

    out["sample_sorted"]["device_ms"] = _device_ms(
        lambda: (K.sample_sorted2(dg.col_indices, dg.edge_values, ex.eid),
                 K.sample_sorted(half, ex.src)))
    print(f"[kernels] sample_sorted device time (torch.profiler): "
          f"{out['sample_sorted']['device_ms']:.4f} ms a round's pair")

    # K7: the fused round's min with aux, and a sum, on the sorted lanes;
    # then BC's backward sum by source over the frontier with the source
    # vertex (the largest degree) added, whose run spans many tiles.
    dst, w = two
    sd, order = torch.sort(dst, stable=True)
    cand = (one + w)[order]
    aux = half[sd.long()]
    kw_min = dict(op="min", out_lanes=min(dg.e_pad, dg.v_pad), aux=aux)
    kw_sum = dict(op="sum", out_lanes=dg.v_pad)
    finite = torch.where(torch.isfinite(cand), cand, 0.0)
    ring = expand(dg, torch.unique(torch.cat([frontier, torch.tensor(
        [src], dtype=torch.int32, device=dev)])), with_dst=False)
    add = torch.from_numpy(rng.random(ring.total, dtype=np.float32)).to(dev)
    kw_ring = dict(op="sum", out_lanes=min(ring.total, dg.v_pad) + 128)
    at = torch.nonzero(ring.src == src).flatten()
    hub_lanes = at.shape[0]
    hub_tiles = int(at[-1]) // K.REDUCE_TILE - int(at[0]) // K.REDUCE_TILE + 1
    ids, vals, cnt = K.reduce_by_dst_sorted(sd, cand, **kw_min)
    again = K.reduce_by_dst_sorted(sd, cand, **kw_min)
    want = K.reduce_by_dst_sorted_plain(sd, cand, **kw_min)
    sums = {}
    for label, keys, x, kw in (("sum", sd, finite, kw_sum),
                               ("ring", ring.src, add, kw_ring)):
        sums[label] = (K.reduce_by_dst_sorted(keys, x, **kw),
                       K.reduce_by_dst_sorted(keys, x, **kw),
                       K.reduce_by_dst_sorted_plain(keys, x, **kw))
    torch.cuda.synchronize()
    k = int(cnt)
    if k != int(want[2]) or k == 0:
        raise AssertionError(f"K7 count {k} vs {int(want[2])}")
    if not (torch.equal(ids[:k], want[0][:k]) and
            torch.equal(vals[:k], want[1][:k])):
        raise AssertionError("K7 ids or min values differ")
    if not torch.equal(vals[:k], again[1][:k]):
        raise AssertionError("K7: two launches differ")
    rel = {}
    for label, (got, got2, swant) in sums.items():
        ks = int(got[2])
        if ks != int(swant[2]) or ks != int(got2[2]) or \
                not torch.equal(got[0][:ks], swant[0][:ks]):
            raise AssertionError(f"K7 {label}: ids or count differ")
        if not torch.equal(got[1][:ks], got2[1][:ks]):
            raise AssertionError(f"K7 {label}: two launches differ")
        rel[label] = _errs(got[1][:ks], swant[1][:ks])
        if rel[label][1] > 1e-6:
            raise AssertionError(f"K7 {label}: max rel err "
                                 f"{rel[label][1]:.3e}")
    m = sd.shape[0]
    runs = int((sd[1:] != sd[:-1]).sum()) + 1
    # keys and values once, aux at the run tails, the kept runs written
    work = bound(8 * m + 4 * runs + 8 * k + 4, m)
    every_lane = bound(12 * m + 8 * k + 4, m)
    report("reduce_by_dst_sorted", rel["sum"][0],
           _median_ms(lambda: K.reduce_by_dst_sorted(sd, cand, **kw_min)),
           _median_ms(lambda: K.reduce_by_dst_sorted_plain(sd, cand,
                                                           **kw_min), reps=5),
           f"{m} lanes, {k} improving runs of {runs}; min exact, sum max "
           f"rel err {rel['sum'][1]:.3e}, bitwise over two launches; BC's "
           f"ring by source, {ring.total} lanes, the source's run "
           f"{hub_lanes} lanes over {hub_tiles} tiles, max rel err "
           f"{rel['ring'][1]:.3e}, bitwise over two launches (time: min "
           f"with aux)", work)
    print(f"[kernels] reduce_by_dst_sorted bound: {work['bound_ms']:.4f} ms "
          f"for 8 m + 4 runs + 8 k + 4 bytes; {every_lane['bound_ms']:.4f} "
          f"ms for 12 m + 8 k + 4 (aux at every lane)")
    out["reduce_by_dst_sorted"]["device_ms"] = _device_ms(
        lambda: K.reduce_by_dst_sorted(sd, cand, **kw_min))
    out["reduce_by_dst_sorted"]["ring_device_ms"] = _device_ms(
        lambda: K.reduce_by_dst_sorted(ring.src, add, **kw_ring))
    print(f"[kernels] reduce_by_dst_sorted device time (torch.profiler): "
          f"{out['reduce_by_dst_sorted']['device_ms']:.4f} ms a call, min "
          f"with aux; "
          f"{out['reduce_by_dst_sorted']['ring_device_ms']:.4f} ms BC's "
          f"ring sum")

    # K8: the fused round's min, and add; float32 and int32.
    ints = torch.from_numpy(rng.integers(-1000, 1000, dg.v_pad,
                                         dtype=np.int32)).to(dev)
    ivals = (ids % 1000).to(torch.int32)
    for op in ("min", "add"):
        for dense, v in ((half, vals), (ints, ivals)):
            got = K.scatter_sorted(dense.clone(), ids, v, count=cnt, op=op)
            want = K.scatter_sorted_plain(dense.clone(), ids, v, count=k,
                                          op=op)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K8 {op} {dense.dtype} differs")
    scratch = half.clone()
    ids_k, vals_k = ids[:k].long(), vals[:k]
    lib = half.clone().index_reduce_(0, ids_k, vals_k, "amin")
    if not torch.equal(lib, K.scatter_sorted(half.clone(), ids, vals,
                                             count=cnt, op="min")):
        raise AssertionError("K8 differs from index_reduce_")
    report("scatter_sorted", 0.0,
           _median_ms(lambda: K.scatter_sorted(scratch, ids, vals, count=cnt,
                                               op="min")),
           _median_ms(lambda: K.scatter_sorted_plain(scratch, ids, vals,
                                                     count=k, op="min")),
           f"{k} winners; min and add, float32 and int32, exact "
           f"(time: min, count read on the device)",
           bound(16 * k + 4, k),
           _median_ms(lambda: scratch.index_reduce_(0, ids_k, vals_k,
                                                    "amin")))
    out["scatter_sorted"]["device_ms"] = _device_ms(
        lambda: K.scatter_sorted(scratch, ids, vals, count=cnt, op="min"))
    out["scatter_sorted"]["library_device_ms"] = _device_ms(
        lambda: scratch.index_reduce_(0, ids_k, vals_k, "amin"))
    print(f"[kernels] scatter_sorted device time (torch.profiler): "
          f"{out['scatter_sorted']['device_ms']:.4f} ms a call vs "
          f"index_reduce_ "
          f"{out['scatter_sorted']['library_device_ms']:.4f} ms")

    # K6: SWEEPS sweeps from the source, add/val and incr; none from
    # every vertex's own id (CC's labels).
    init = torch.full((dg.v_pad,), float("inf"), device=dev)
    init[src] = 0.0
    ids = torch.arange(dg.v_pad, device=dev, dtype=torch.float32)
    for wmode, start in (("add", init), ("incr", init), ("none", ids)):
        got, chg = P.pull_min_sweeps(dg, start, sweeps=SWEEPS, wmode=wmode)
        want, wchg = P.pull_min_sweeps_plain(dg, start, sweeps=SWEEPS,
                                             wmode=wmode)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(chg, wchg)):
            raise AssertionError(f"K6 {wmode} differs from its plain version")
        print(f"[kernels] K6 {wmode}: distances and change counts equal "
              f"{chg.tolist()}")
    # The active sources of each sweep (not +inf at the call's start, then
    # lowered by the previous sweep), from the plain sweeps: the edges the
    # kernel reads by its group rule, and those of the sources alone.
    source_edges = []
    d = init
    active = d != float("inf")
    srcs = dg.csc_indices[:dg.num_edges].long()
    for r in range(SWEEPS):
        tiles, _, edges = tile_activity(dg, active)
        source_edges.append(int(active[srcs].sum()))
        fresh, _ = P.pull_min_sweeps_plain(dg, d, sweeps=1)
        print(f"[kernels] K6 add sweep {r}: pass 1 reduced {tiles} of "
              f"{num_tiles(dg)} tiles; {edges} active edges of "
              f"{dg.num_edges} ({source_edges[-1]} of active sources)")
        active, d = fresh < d, fresh
    full = bound(SWEEPS * pull_bytes(dg.num_edges, dg.v_pad, 3, 2),
                 SWEEPS * 2 * dg.num_edges)
    # a sweep: index and weight of each active source's edge; values,
    # offsets and output vectors; an add and a min an edge
    work = bound(sum(8 * e + 12 * dg.v_pad for e in source_edges),
                 sum(2 * e for e in source_edges))
    print(f"[kernels] K6 bound over the active edges "
          f"{work['bound_ms']:.4f} ms; every edge every sweep "
          f"{full['bound_ms']:.4f} ms")
    report("pull_min_sweeps", 0.0,
           _median_ms(lambda: P.pull_min_sweeps(dg, init, sweeps=SWEEPS)),
           _median_ms(lambda: P.pull_min_sweeps_plain(dg, init,
                                                      sweeps=SWEEPS), reps=5),
           f"{SWEEPS} sweeps add/val from the source (time: {SWEEPS} sweeps)",
           work)
    return out


def phase_sssp_timing(g, src, dg, gg, dgw, card):
    """Phase 15: best of RUNS SSSP and non-DO BFS runs after a warm-up."""
    import numpy as np
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.models.sssp import sssp_device

    def visited(graph, reached):
        degs = np.diff(graph.row_offsets.astype(np.int64))
        return int(degs[reached].sum())

    delta = 32.0 * float(np.mean(g.edge_values))
    ev = visited(g, np.isfinite(
        sssp_device(dg, src)[0][:g.num_nodes].cpu().numpy()))
    gev = gg.num_edges
    for name, fn, edges in (
            ("sssp flagship sweep route", lambda: sssp_device(dg, src), ev),
            ("sssp flagship near-far",
             lambda: sssp_device(dg, src, mode="nearfar", delta=delta), ev),
            ("sssp flagship near-far fused",
             lambda: sssp_device(dg, src, mode="nearfar", delta=delta,
                                 fused=True), ev),
            ("sssp grid", lambda: sssp_device(dgw, 0, mode="pull",
                                              delta=GRID_DELTA), gev),
            ("non-DO bfs grid", lambda: bfs_device(dgw, 0), gev)):
        best, times = best_of(fn)
        print(f"[timing] {name}: best {best:.3f} ms of {RUNS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); "
              f"{edges / (best * 1000.0):.1f} MTEPS (edges {edges}); "
              f"on {card}")


def phase_bc(gtt, g, src, dg, bfs_labels):
    """Phases 16 and 17: BC on the kernel-C route (K9), held against the
    float64 oracle, then the hybrid, fused and all-pull routes against
    it. Returns the main-path launch counts: K9 from phase 16, the rest
    from phase 17."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.utils import reference as oracle

    # 16. Kernel C.
    if not (dg.has_pull2 and dg.undirected):
        raise AssertionError("phase 11's graph should take the kernel-C route")
    K.reset_launch_counts()
    main = gtt.bc(dg, src)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"[bc] kernel C: route {main.info['route']}, search_depth "
          f"{main.info['search_depth']}, discovered per level "
          f"{main.info['per_iteration_frontier']}, process "
          f"{main.info['process_ms']:.3f} ms; kernel launches {launches}")
    if main.info["route"] != "pull2" or launches["brandes_levels"] <= 0:
        raise AssertionError("K9 was not launched on the kernel-C route")
    if not np.array_equal(main.labels, bfs_labels):
        raise AssertionError("BC labels differ from phase 3's BFS labels")
    t0 = time.perf_counter()
    labels, sigma, delta = oracle.cpu_brandes(g, src)
    print(f"[bc] float64 oracle {time.perf_counter() - t0:.3f} s; largest "
          f"path count {sigma.max():.6e}")
    if not np.array_equal(labels, main.labels):
        raise AssertionError("BC labels differ from the oracle's")
    check_close("bc sigma vs float64 oracle", main.sigmas, sigma,
                rtol=1e-4, atol=0.0)
    delta[src] = 0.0
    check_close("bc vs float64 oracle", main.bc_values, 0.5 * delta,
                rtol=1e-3, atol=1e-3)

    # 17. The other routes. The hybrid pulls forward level d + 1 and
    # backward ring d where level d's out-degree sum passes E / 32.
    deg = np.diff(g.row_offsets.astype(np.int64))
    reached = main.labels >= 0
    msum = np.bincount(main.labels[reached], weights=deg[reached])
    seq = ["pull" if m > max(1, g.num_edges // 32) else "push" for m in msum]
    print(f"[bc] hybrid's frontier edges per level "
          f"{msum.astype(np.int64).tolist()}: forward {seq}, backward "
          f"{seq[::-1]}")
    other = {}
    for name, flags, instrumented in (
            ("hybrid", {}, False),
            ("hybrid fused", {"GUNROCK_BC_FUSED": "1"}, False),
            ("all-pull (instrumented)", {}, True)):
        K.reset_launch_counts()
        with patch.dict(os.environ, GUNROCK_BC_PULL2="0", **flags):
            res = gtt.bc(dg, src, instrumented=instrumented)
        torch.cuda.synchronize()
        n = dict(K.LAUNCHES)
        print(f"[bc] {name}: route {res.info['route']}, iterations "
              f"{res.info['num_iterations']}, process "
              f"{res.info['process_ms']:.3f} ms; kernel launches {n}")
        want_k3 = 2 * seq.count("pull")
        if instrumented:
            want_k3 = len(res.info["per_iteration"])
            print("[bc] all-pull levels: " + ", ".join(
                f"{r['phase'][0]}{r['level']}:{r['ms']:.3f} ms"
                for r in res.info["per_iteration"]))
        if n["pull_reduce2"] != want_k3 or n["brandes_levels"]:
            raise AssertionError(f"{name}: K3 launched {n['pull_reduce2']} "
                                 f"times, expected {want_k3}, and K9 "
                                 f"{n['brandes_levels']} times")
        if flags and min(n["sample_sorted"], n["reduce_by_dst_sorted"],
                         n["scatter_sorted"]) <= 0:
            raise AssertionError("K5, K7 or K8 was not launched by the fused "
                                 "hybrid")
        if not np.array_equal(res.labels, main.labels):
            raise AssertionError(f"{name}: labels differ from kernel C's")
        check_close(f"bc {name} sigma vs kernel C", res.sigmas, main.sigmas,
                    rtol=1e-4, atol=0.0)
        check_close(f"bc {name} vs kernel C", res.bc_values, main.bc_values,
                    rtol=1e-3, atol=1e-3)
        for k, v in n.items():
            other[k] = other.get(k, 0) + v
    other["brandes_levels"] = launches["brandes_levels"]
    return other


def phase_cc(gtt, g, dev):
    """Phase 18: CC on the flagship, hooking and the sweeps route, against
    scipy. Returns the graph and the launch counts of both runs."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.utils import reference as oracle

    t0 = time.perf_counter()
    dgc = gtt.to_device(g, with_edge_src=True, with_blocked_values=True,
                        device=dev)
    torch.cuda.synchronize()
    print(f"[cc] to_device(with_edge_src, with_blocked_values) "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    ref = oracle.cpu_cc(g)
    isolated = int((np.diff(g.row_offsets) == 0).sum())
    print(f"[cc] scipy components {time.perf_counter() - t0:.3f} s: "
          f"{len(np.unique(ref))} components, {isolated} isolated vertices")
    launches = {}
    for name, flags in (("hooking", {}),
                        ("sweeps", {"GUNROCK_CC_SWEEPS": "1"})):
        K.reset_launch_counts()
        with patch.dict(os.environ, flags):
            res = gtt.cc(dgc, instrumented=not flags)
        torch.cuda.synchronize()
        n = dict(K.LAUNCHES)
        print(f"[cc] {name}: route {res.info['route']}, iterations "
              f"{res.info['num_iterations']}, per-round frontier "
              f"{res.info['per_iteration_frontier']}, process "
              f"{res.info['process_ms']:.3f} ms; kernel launches {n}")
        if flags:
            if res.info["route"] != "pull_sweeps" or \
                    n["pull_min_sweeps"] <= 0:
                raise AssertionError("K6 was not launched by the sweeps route")
        else:
            branches = [r["phase"] for r in res.info["per_iteration"]]
            print(f"[cc] remainder rounds: {branches}; K3 launches "
                  f"{n['pull_reduce2']} (one a full-edge round)")
            if n["pull_reduce2"] != branches.count("full_edge"):
                raise AssertionError("K3 launches do not match the full-edge "
                                     "rounds")
        if not np.array_equal(res.components, ref) or \
                res.num_components != len(np.unique(ref)):
            raise AssertionError(f"cc {name}: components differ from scipy's")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    print("[cc] components equal scipy's on both routes")
    return dgc, launches


def phase_bc_kernels(dg, src, dev):
    """Phase 19: K9 against its plain version at the flagship's shapes,
    one whole BC source as the kernel-C route runs it: every forward
    level in calls of BC_LEVELS, then every backward ring; and against
    its composition from K3 (``pull_reduce2`` sum/none over the gated
    values, then the epilogue in torch), which it equals bit for bit.
    Prints each level's tiles and active edges by K9's rules. Returns
    K9's JSON fields."""
    import torch
    from gunrock_tpu_torch.ops import pull2 as P
    inf = float("inf")
    lab0 = torch.full((dg.v_pad,), inf, device=dev)
    lab0[src] = 0.0
    sig0 = torch.zeros(dg.v_pad, device=dev)
    sig0[src] = 1.0

    def brandes(fwd, bwd):
        lab, sig, d, counts = lab0, sig0, 1, []
        while True:
            lab, sig, chg = fwd(dg, lab, sig, d0=d, levels=BC_LEVELS)
            counts.append(chg)
            chg = chg.tolist()
            if 0 in chg:
                depth = d + chg.index(0) - 1
                break
            d += BC_LEVELS
        delta = torch.zeros(dg.v_pad, device=dev)
        for t in range(depth - 1, -1, -BC_LEVELS):
            delta, ring = bwd(dg, lab, sig, delta, t0=t,
                              levels=min(BC_LEVELS, t + 1))
            counts.append(ring)
        return lab, sig, delta, torch.cat(counts)

    levels_seen = []

    def k3_fwd(g, lab, sig, *, d0, levels):
        counts = []
        for d in range(d0, d0 + levels):
            gated = torch.where(lab == float(d - 1), sig, 0.0)
            open_ = lab == inf
            levels_seen.append((f"forward {d}",
                                tile_activity(g, gated != 0, open_)))
            acc = P.pull_reduce2(gated, g)
            sig = torch.where(open_, sig + acc, sig)
            new = open_ & (sig > 0)
            lab = torch.where(new, float(d), lab)
            counts.append(new.sum())
        return lab, sig, torch.stack(counts).to(torch.int32)

    def k3_bwd(g, lab, sig, delta, *, t0, levels):
        counts = []
        for t in range(t0, t0 - levels, -1):
            gated = torch.where(lab == float(t + 1),
                                (1.0 + delta) / sig.clamp(min=1e-30), 0.0)
            ring = lab == float(t)
            levels_seen.append((f"backward {t}",
                                tile_activity(g, gated != 0, ring)))
            acc = P.pull_reduce2(gated, g)
            delta = torch.where(ring, sig * (delta + acc), delta)
            counts.append(ring.sum())
        return delta, torch.stack(counts).to(torch.int32)

    got = brandes(P.brandes_fwd_levels, P.brandes_bwd_levels)
    again = brandes(P.brandes_fwd_levels, P.brandes_bwd_levels)
    composed = brandes(k3_fwd, k3_bwd)
    want = brandes(P.brandes_fwd_levels_plain, P.brandes_bwd_levels_plain)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("K9: two launches differ")
    if not all(torch.equal(a, b) for a, b in zip(got, composed)):
        raise AssertionError("K9 differs from its composition from K3")
    if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])):
        raise AssertionError("K9 labels or counts differ from the plain "
                             "version's")
    for name, (tiles, live, edges) in levels_seen:
        print(f"[kernels] K9 {name}: pass 1 reduced {tiles} of "
              f"{num_tiles(dg)} tiles ({live} live); {edges} active edges")
    errs = []
    for name, i in (("sigma", 1), ("delta", 2)):
        abs_err, rel_err = _errs(got[i], want[i])
        errs.append(abs_err)
        bad = int(((got[i] - want[i]).abs()
                   > 1e-5 * want[i].abs() + 1e-6).sum())
        print(f"[kernels] K9 {name}: max abs err {abs_err:.3e}, max rel err "
              f"{rel_err:.3e} (rtol 1e-5, atol 1e-6), {bad} outside")
        if bad:
            raise AssertionError(f"K9 {name} differs from its plain version")
    levels = got[3].shape[0]
    # What this source needs: each phase reads the in-edges of the reached
    # vertices once (an index and an add each) and lab, sig and delta in
    # and out once.
    reached = int(torch.where(got[0] < inf, dg.out_degrees(), 0).sum())
    work = bound(2 * (4 * reached + 16 * dg.v_pad), 2 * reached)
    ms = _median_ms(lambda: brandes(P.brandes_fwd_levels,
                                    P.brandes_bwd_levels))
    plain = _median_ms(lambda: brandes(P.brandes_fwd_levels_plain,
                                       P.brandes_bwd_levels_plain), reps=3)
    print(f"[kernels] K9 brandes_levels: {levels} levels (counts "
          f"{got[3].tolist()}), labels and counts exact, bitwise over two "
          f"launches and equal to K3's composition; one source {ms:.4f} ms "
          f"vs plain {plain:.4f} ms; bound {work['bound_ms']:.4f} ms "
          f"({reached} reached edges a phase)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
            "library_ms": None, **work}


def phase_bc_timing(g, src, dg, dgc, card):
    """Phase 20: best of RUNS BC and CC runs after a warm-up, in
    bench_all.py's accounting (BC 2E, CC E)."""
    from gunrock_tpu_torch.models import bc_device, cc_device
    e = g.num_edges
    for name, fn, edges, flags in (
            ("bc kernel C", lambda: bc_device(dg, src), 2 * e, {}),
            ("bc hybrid", lambda: bc_device(dg, src), 2 * e,
             {"GUNROCK_BC_PULL2": "0"}),
            ("bc hybrid fused", lambda: bc_device(dg, src, fused=True),
             2 * e, {"GUNROCK_BC_PULL2": "0"}),
            ("cc hooking", lambda: cc_device(dgc), e, {}),
            ("cc sweeps", lambda: cc_device(dgc), e,
             {"GUNROCK_CC_SWEEPS": "1"})):
        with patch.dict(os.environ, flags):
            best, times = best_of(fn)
        print(f"[timing] {name}: best {best:.3f} ms of {RUNS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); "
              f"{edges / (best * 1000.0):.1f} MTEPS (edges {edges}); "
              f"on {card}")


def phase_bfs_rest(gtt, g, src, bfs_labels, gg, dgw, dev):
    """Phase 21: DO-BFS with predecessors on the flagship uploaded
    ``with_csc`` only (pull levels through K10), then DO-BFS with
    predecessors on the grid (the deep micro-loop). Returns the K10
    graph, the frontier depth of each pull level and K10's launches."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    dgk = gtt.to_device(g, with_csc=True, device=dev)
    torch.cuda.synchronize()
    print(f"[bfs-k10] to_device(with_csc) {time.perf_counter() - t0:.3f} s; "
          f"has_blocked_csc {dgk.has_blocked_csc}")
    if dgk.has_blocked_csc:
        raise AssertionError("a with_csc-only graph has no blocked CSC")
    K.reset_launch_counts()
    records = []
    labels, preds, st = bfs_device(dgk, src, mark_preds=True,
                                   direction_optimized=True,
                                   instrument=records)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print("[bfs-k10] levels: " + ", ".join(
        f"{r['iteration']}:{r['phase']}(n={r['frontier']}, {r['ms']:.3f} ms)"
        for r in records))
    print(f"[bfs-k10] kernel launches: {launches}")
    pull_depths = [r["iteration"] - 1 for r in records
                   if r["phase"] == "pull"]
    if not pull_depths or \
            launches["bitmask_gather_cumsum"] != len(pull_depths):
        raise AssertionError(f"K10 launched {launches['bitmask_gather_cumsum']}"
                             f" times over {len(pull_depths)} pull levels")
    if launches["pull_reached_words"]:
        raise AssertionError("K1 was launched on a graph without the "
                             "blocked CSC")
    n = g.num_nodes
    lab = labels[:n].cpu().numpy()
    if not np.array_equal(lab, bfs_labels):
        raise AssertionError("K10 route's labels differ from phase 3's")
    check_preds(g, src, lab, preds[:n].cpu().numpy())
    print("[bfs-k10] labels equal phase 3's; preds valid; K10 once a pull "
          "level, K1 never")

    K.reset_launch_counts()
    records = []
    t0 = time.perf_counter()
    labels, preds, st = bfs_device(dgw, 0, mark_preds=True,
                                   direction_optimized=True,
                                   instrument=records)
    torch.cuda.synchronize()
    phases = [r["phase"] for r in records]
    print(f"[bfs-deep] grid DO-BFS from 0 (instrumented): {st.iteration} "
          f"levels in {st.deep_stretches} deep stretches, "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms; phases "
          f"{ {p: phases.count(p) for p in sorted(set(phases))} }; kernel "
          f"launches {dict(K.LAUNCHES)}")
    if set(phases) != {"deep"}:
        raise AssertionError("the grid's DO-BFS should run every level in "
                             "the deep micro-loop")
    lab = labels[:gg.num_nodes].cpu().numpy()
    check_labels(gg, 0, lab)
    check_preds(gg, 0, lab, preds[:gg.num_nodes].cpu().numpy())
    print("[bfs-deep] labels equal scipy's depths; preds valid")
    return dgk, pull_depths, launches["bitmask_gather_cumsum"]


def phase_k10_kernel(dgk, bfs_labels, pull_depths, dev):
    """Phase 22: K10 against its plain version at the shapes of every
    pull level of phase 21 (the frontier of that depth, all CSC sources)
    and at K10_ODD_LENGTH ids. Returns K10's JSON fields, its time and
    bound summed over the pull levels as K1's are."""
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    labels = torch.full((dgk.v_pad,), -1, dtype=torch.int32, device=dev)
    labels[:bfs_labels.shape[0]] = torch.from_numpy(bfs_labels).to(dev)
    idx = dgk.csc_indices
    out = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None}
    for d in pull_depths:
        words = K.pack_bitmask(labels == d)
        got = K.bitmask_gather_cumsum(words, idx)
        want = K.bitmask_gather_cumsum_plain(words, idx)
        torch.cuda.synchronize()
        out["max_abs_err"] = max(out["max_abs_err"], _max_abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"K10 differs from its plain version at the "
                                 f"pull of depth {d}")
        ms = _median_ms(lambda: K.bitmask_gather_cumsum(words, idx))
        plain = _median_ms(lambda: K.bitmask_gather_cumsum_plain(words, idx),
                           reps=5)
        out["ms"] += ms
        out["plain_ms"] += plain
        print(f"[kernels] K10 bitmask_gather_cumsum, frontier of depth {d} "
              f"({int((labels == d).sum())} bits), {idx.shape[0]} ids: "
              f"equal, last sum {int(got[-1])}; {ms:.4f} ms vs plain "
              f"{plain:.4f} ms")
    odd = idx[:K10_ODD_LENGTH]
    if not torch.equal(K.bitmask_gather_cumsum(words, odd),
                       K.bitmask_gather_cumsum_plain(words, odd)):
        raise AssertionError("K10 differs from its plain version at "
                             f"{K10_ODD_LENGTH} ids")
    fronts = [K.pack_bitmask(labels == d) for d in pull_depths]
    out["device_ms"] = _device_ms(
        lambda: [K.bitmask_gather_cumsum(w, idx) for w in fronts])
    hits = K.bitmask_gather_plain(words, idx)
    cum_ms = _median_ms(lambda: torch.cumsum(hits, 0, dtype=torch.int32))
    # A level: the ids read and the sums written, 4 bytes each an id, and
    # the frontier words.
    out.update(bound(len(pull_depths) * (8 * idx.shape[0]
                                         + 4 * words.shape[0])))
    print(f"[kernels] K10 equal at {K10_ODD_LENGTH} ids too; summed over "
          f"the {len(pull_depths)} pull levels {out['ms']:.4f} ms vs plain "
          f"{out['plain_ms']:.4f} ms; device {out['device_ms']:.4f} ms; "
          f"bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); for a redesign: torch.cumsum over "
          f"precomputed hits {cum_ms:.4f} ms a level (no PyTorch call "
          f"computes K10's function)")
    return out


def phase_bfs_timing(src, edges_visited, dgb, dgk, gg, dgw, card):
    """Phase 23: best of RUNS BFS runs after a warm-up: DO-BFS on the
    flagship with the blocked CSC (K1), with and without the deep
    micro-loop, and without the blocked CSC (K10); DO and non-DO BFS on
    the grid with and without the deep micro-loop."""
    from gunrock_tpu_torch.models.bfs import bfs_device
    off = {"GUNROCK_BFS_DEEP": "0"}
    for name, fn, edges, flags in (
            ("DO-BFS flagship, K1 graph",
             lambda: bfs_device(dgb, src, direction_optimized=True),
             edges_visited, {}),
            ("DO-BFS flagship, K1 graph, GUNROCK_BFS_DEEP=0",
             lambda: bfs_device(dgb, src, direction_optimized=True),
             edges_visited, off),
            ("DO-BFS flagship, K10 graph",
             lambda: bfs_device(dgk, src, direction_optimized=True),
             edges_visited, {}),
            ("DO-BFS grid, deep micro-loop",
             lambda: bfs_device(dgw, 0, direction_optimized=True),
             gg.num_edges, {}),
            ("DO-BFS grid, GUNROCK_BFS_DEEP=0",
             lambda: bfs_device(dgw, 0, direction_optimized=True),
             gg.num_edges, off),
            ("non-DO BFS grid, deep micro-loop", lambda: bfs_device(dgw, 0),
             gg.num_edges, {}),
            ("non-DO BFS grid, GUNROCK_BFS_DEEP=0",
             lambda: bfs_device(dgw, 0), gg.num_edges, off)):
        with patch.dict(os.environ, flags):
            best, times = best_of(fn)
        print(f"[timing] {name}: best {best:.3f} ms of {RUNS} "
              f"({', '.join(f'{t:.3f}' for t in times)}); "
              f"{edges / (best * 1000.0):.1f} MTEPS (edges {edges}); "
              f"on {card}")


def phase_above_cap(gtt, dev):
    """Phase 24: R-MAT scale 21, edge factor 4, seed 1, undirected
    (2,097,152 vertices: frontier masks of 65,536 words, above what K10
    holds in shared memory), uploaded with the blocked CSC (pulls
    through K1) and ``with_csc`` only (K10). DO-BFS with predecessors
    from the largest-degree vertex on each: labels equal scipy's depths,
    predecessors valid, each pull level through its kernel; then K10,
    which the size rule sends through L1, and K1 (through L1 at every
    size) exactly equal to their plain versions at the frontier of every
    level."""
    import torch
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    g = gtt.io.rmat(scale=21, edge_factor=4, seed=SEED, undirected=True)
    src = g.largest_degree_vertex()
    print(f"[cap] rmat n21 e4 seed {SEED}: |V|={g.num_nodes} "
          f"|E|={g.num_edges}, host build {time.perf_counter() - t0:.3f} s")
    for kernel, kw in (("pull_reached_words", {"with_blocked_csc": True}),
                       ("bitmask_gather_cumsum", {"with_csc": True})):
        dgx = gtt.to_device(g, device=dev, **kw)
        K.reset_launch_counts()
        records = []
        labels, preds, _ = bfs_device(dgx, src, mark_preds=True,
                                      direction_optimized=True,
                                      instrument=records)
        torch.cuda.synchronize()
        pulls = [r["phase"] for r in records].count("pull")
        if K.LAUNCHES[kernel] != pulls:
            raise AssertionError(f"{kernel} launched {K.LAUNCHES[kernel]} "
                                 f"times over {pulls} pull levels")
        lab = labels[:g.num_nodes].cpu().numpy()
        check_labels(g, src, lab)
        check_preds(g, src, lab, preds[:g.num_nodes].cpu().numpy())
        ms = 0.0
        depth = int(labels.max())
        for d in range(depth + 1):
            words = K.pack_bitmask(labels == d)
            if words.shape[0] <= K.SHARED_MASK_WORDS:
                raise AssertionError("the mask fits K10's shared variant")
            if kernel == "pull_reached_words":
                run = lambda: K.pull_reached_words(words, dgx)
                want = K.pull_reached_words_plain(words, dgx)
            else:
                run = lambda: K.bitmask_gather_cumsum(words, dgx.csc_indices)
                want = K.bitmask_gather_cumsum_plain(words, dgx.csc_indices)
            if not torch.equal(run(), want):
                raise AssertionError(f"{kernel} differs from its plain "
                                     f"version above the cap at level {d}")
            ms += _median_ms(run, reps=5)
        print(f"[cap] {kernel}: DO-BFS labels equal scipy's depths, preds "
              f"valid, {pulls} pull levels through it; at masks of "
              f"{words.shape[0]} words (through L1), equal to the plain "
              f"version at all {depth + 1} levels ({ms:.4f} ms summed)")
        del dgx


TC_SCALE, TC_EDGE_FACTOR = 14, 16   # phase 26's exact check against cpu_tc
TC_SMALL_BUDGET = 1 << 20           # and its several-chunk run
TC_SAMPLED_EDGES = 100_000
TC_PROFILED_CHUNKS = 5


def phase_tc(gtt, g, src, bfs_labels, dgv, card):
    """Phase 26: TC on the flagship through ``gtt.tc`` (its chunk count,
    the count identities, 100,000 sampled oriented edges against
    ``np.intersect1d`` of their DAG rows), exact against ``cpu_tc`` on
    R-MAT scale 14 in one chunk and in several, the ``tc`` CLI, ``sample``
    from the hub against phase 3's labels, the A4 operators on the card
    against the same functions on the CPU, then TC's timing (best of RUNS
    ``process_ms`` after a warm-up, wedges per microsecond), the device
    time of its first chunks split by step and its busy share."""
    import importlib

    import numpy as np
    import torch
    from gunrock_tpu_torch.ops import cull_filter, expand_inverse, pull_reduce
    from gunrock_tpu_torch.ops import intersection as I
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.tools.profile_value import profile_run
    from gunrock_tpu_torch.utils.reference import cpu_tc
    tcm = importlib.import_module("gunrock_tpu_torch.models.tc")
    dev = dgv.device

    t0 = time.perf_counter()
    prep = tcm._tc_prepare(g)
    dag = prep.dag
    print(f"[tc] host prep {time.perf_counter() - t0:.3f} s: "
          f"{dag.num_edges} oriented edges, largest oriented out-degree "
          f"{int(np.diff(dag.row_offsets).max())}, {prep.wedge_total} "
          f"wedges, {len(prep.bounds) - 1} chunks of at most "
          f"{tcm._default_wedge_budget()} wedges")
    K.reset_launch_counts()
    res = gtt.tc(g, device="cuda")
    info = res.info
    print(f"[tc] flagship: {res.total} triangles, {info['num_chunks']} "
          f"chunks, wedges_probed {info['wedges_probed']}, preprocess "
          f"{info['preprocess_ms']:.3f} ms, process {info['process_ms']:.3f} "
          f"ms; kernel launches {dict(K.LAUNCHES)}")
    if info["num_chunks"] != len(prep.bounds) - 1:
        raise AssertionError("TC's chunk count differs from _tc_prepare's")
    if int(res.edge_counts.sum(dtype=np.int64)) != res.total or \
            int(res.vertex_counts.sum()) != 3 * res.total:
        raise AssertionError("TC's per-edge or per-vertex counts do not sum "
                             "to the total")
    rng = np.random.default_rng(SEED)
    row, col = dag.row_offsets, dag.col_indices
    esrc = prep.esrc_full
    t0 = time.perf_counter()
    for e in rng.choice(dag.num_edges, TC_SAMPLED_EDGES, replace=False):
        u, v = esrc[e], col[e]
        want = np.intersect1d(col[row[u]:row[u + 1]], col[row[v]:row[v + 1]],
                              assume_unique=True).size
        if res.edge_counts[e] != want:
            raise AssertionError(f"TC count of oriented edge {e} ({u}, {v}) "
                                 f"is {res.edge_counts[e]}, not {want}")
    print(f"[tc] the counts of {TC_SAMPLED_EDGES} sampled oriented edges "
          f"equal np.intersect1d of their DAG rows "
          f"({time.perf_counter() - t0:.3f} s)")

    gs = gtt.io.rmat(scale=TC_SCALE, edge_factor=TC_EDGE_FACTOR, seed=SEED,
                     undirected=True)
    one = gtt.tc(gs, device="cuda")
    t0 = time.perf_counter()
    want = cpu_tc(gs)
    with patch.dict(os.environ,
                    {"GUNROCK_TC_WEDGE_BUDGET": str(TC_SMALL_BUDGET)}):
        many = gtt.tc(gs, device="cuda")
    if not one.total == many.total == want:
        raise AssertionError(f"TC on rmat n{TC_SCALE}: {one.total} and "
                             f"{many.total}, cpu_tc {want}")
    if many.info["num_chunks"] < 2 or not (
            np.array_equal(one.edge_counts, many.edge_counts) and
            np.array_equal(one.vertex_counts, many.vertex_counts)):
        raise AssertionError("TC's several-chunk run differs from its "
                             "one-chunk run")
    print(f"[tc] rmat n{TC_SCALE} e{TC_EDGE_FACTOR}: {one.total} triangles, "
          f"equal to cpu_tc ({time.perf_counter() - t0:.3f} s) in "
          f"{one.info['num_chunks']} chunk and, at a budget of "
          f"{TC_SMALL_BUDGET} wedges, in {many.info['num_chunks']} chunks "
          f"with equal counts")
    cmd = [sys.executable, "-m", "gunrock_tpu_torch", "tc", "rmat",
           "--rmat_scale=12", "--undirected"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [line for line in out.stdout.splitlines() if "validation" in line]
    print(f"[tc] {' '.join(cmd[1:])}: exit {out.returncode}; {lines}")
    if out.returncode != 0 or lines != ["tc validation: CORRECT"]:
        raise AssertionError(f"the tc CLI failed: {out.stderr[-2000:]}")

    labels = gtt.sample(dgv, src)
    if not np.array_equal(labels, bfs_labels):
        raise AssertionError("sample's labels differ from phase 3's")
    print(f"[sample] from the hub on the card: labels equal phase 3's "
          f"(depth {int(labels.max())})")

    t0 = time.perf_counter()
    dc = gtt.to_device(g, with_csc=True, device="cpu")
    frontier = torch.tensor([src], dtype=torch.int32)
    exg = expand_inverse(dgv, frontier.to(dev))
    exc = expand_inverse(dc, frontier)
    if exg.total != exc.total or not all(
            torch.equal(getattr(exg, f).cpu(), getattr(exc, f))
            for f in ("src", "dst", "eid", "rank")):
        raise AssertionError("expand_inverse of the hub differs on the card")
    keep = exc.dst % 3 != 0
    fg = cull_filter(exg.dst, keep.to(dev), size=dgv.v_pad)
    fc = cull_filter(exc.dst, keep, size=dc.v_pad)
    if fg[1] != fc[1] or not (torch.equal(fg[0].cpu(), fc[0]) and
                              torch.equal(fg[2].cpu(), fc[2])):
        raise AssertionError("cull_filter of the hub's lanes differs on the "
                             "card")
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, dc.e_pad).astype(
        np.float32))
    for op in ("sum", "max", "min"):
        got = pull_reduce(dgv, vals.to(dev), op=op).cpu()
        want = pull_reduce(dc, vals, op=op)
        if op == "sum":
            check_close("pull_reduce sum on the card", got.numpy(),
                        want.numpy(), rtol=1e-6, atol=0.0)
        elif not torch.equal(got, want):
            raise AssertionError(f"pull_reduce {op} differs on the card")
    print(f"[ops] the hub's expand_inverse ({exc.total} lanes), cull_filter "
          f"({fc[1]} kept) and pull_reduce sum/max/min on the flagship: "
          f"equal to the CPU's (sum rtol 1e-6) "
          f"({time.perf_counter() - t0:.3f} s)")
    del dc

    def timed():
        return gtt.tc(g, device="cuda").info["process_ms"]

    times = [timed() for _ in range(RUNS)]
    best = min(times)
    print(f"[timing] tc flagship: process_ms best {best:.3f} of {RUNS} "
          f"({', '.join(f'{t:.3f}' for t in times)}); "
          f"{best / info['num_chunks']:.3f} ms a chunk "
          f"({info['num_chunks']}); {prep.wedge_total / (best * 1e3):.1f} "
          f"wedges a microsecond; {res.total} triangles; on {card}")

    # The device time of the first chunks, step by step, and the busy
    # share of a whole run (the upload and the chunk loop).
    drow = torch.from_numpy(prep.row).to(dev)
    dcol = torch.from_numpy(prep.col).to(dev)
    desrc = torch.from_numpy(prep.esrc_full).to(dev)
    n = dag.num_edges
    steps = dict.fromkeys(("expansion", "sort", "run flag and gather",
                           "scatters"), 0.0)
    for a, b in zip(prep.bounds, prep.bounds[1:TC_PROFILED_CHUNKS + 1]):
        cs, cd = desrc[a:b], dcol[a:b]
        u, w, rank, _ = I.wedges(drow, dcol, cs, cd)
        keys, perm = I.join(desrc, dcol[:n], u, w, prep.v_pad)
        hit = I.hits(keys, perm, n)
        for step, fn in (
                ("expansion", lambda: I.wedges(drow, dcol, cs, cd)),
                ("sort", lambda: I.join(desrc, dcol[:n], u, w, prep.v_pad)),
                ("run flag and gather", lambda: I.hits(keys, perm, n)),
                ("scatters", lambda: I.count(hit, w, rank, cs, cd,
                                             prep.v_pad))):
            steps[step] += profile_run(fn, 1, dev)["device_ms"]
        del u, w, rank, keys, perm, hit
    total_ms = sum(steps.values())
    print(f"[tc] device time of the first {TC_PROFILED_CHUNKS} chunks, "
          f"{total_ms:.3f} ms: " + ", ".join(
              f"{k} {v:.3f} ms ({100.0 * v / total_ms:.1f}%)"
              for k, v in steps.items()))
    whole = profile_run(lambda: tcm._tc_run(prep, dev), 1, dev)
    print(f"[tc] a whole run under the profiler: wall "
          f"{whole['wall_ms']:.3f} ms, device {whole['device_ms']:.3f} ms, "
          f"busy {100.0 * whole['device_ms'] / whole['wall_ms']:.1f}%; "
          f"largest: " + "; ".join(f"{name[:60]} {ms:.3f} ms ({calls:.0f})"
                                   for name, calls, ms in whole["events"][:6]))
    del drow, dcol, desrc
    torch.cuda.empty_cache()


def phase_sssp_carry(g, src, dgs, dist, dgw, card):
    """Phase 27: SSSP's value-carry micro-loop (``deep_carry=True``) on
    the flagship with phase 12's near-far delta and on the grid of phase
    13 (delta 256, through the sweeps' bail-out): distances bitwise equal
    to the ``deep_carry=False`` runs, iteration and edge counts equal,
    K5 launched on each graph. Then the grid with and without carry,
    best of 3 each, in turns. Returns K5's launches in the carry runs."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.models.sssp import sssp_device
    from gunrock_tpu_torch.ops import kernels as K

    delta = 32.0 * float(np.mean(g.edge_values))
    k5 = 0
    for name, graph, s, kw in (
            ("flagship near-far", dgs, src, dict(mode="nearfar",
                                                 delta=delta)),
            ("grid", dgw, 0, dict(mode="pull", delta=GRID_DELTA))):
        out = {}
        for carry in (False, True):
            K.reset_launch_counts()
            records = []
            d, _, st = sssp_device(graph, s, deep_carry=carry,
                                   instrument=records, **kw)
            torch.cuda.synchronize()
            out[carry] = (d, st, dict(K.LAUNCHES),
                          [r["phase"] for r in records].count("deep"))
        (d0, st0, n0, deep0), (d1, st1, n1, deep1) = out[False], out[True]
        print(f"[carry] {name}: route {st1.route}, {st1.iteration} rounds "
              f"({deep1} deep); K5 launches with carry: sample_sorted2 "
              f"{n1['sample_sorted2']}, sample_sorted {n1['sample_sorted']} "
              f"(without: {n0['sample_sorted2']}, {n0['sample_sorted']})")
        if not torch.equal(d1, d0) or (name.startswith("flagship") and
                                       not torch.equal(d1, dist)):
            raise AssertionError(f"carry on the {name}: distances differ")
        if (st1.iteration, st1.edges_queued, st1.frontier_trace) != \
                (st0.iteration, st0.edges_queued, st0.frontier_trace):
            raise AssertionError(f"carry on the {name}: the rounds differ")
        if deep1 <= 0 or n1["sample_sorted2"] <= 0 or \
                n1["sample_sorted2"] != n0["sample_sorted2"] or \
                n0["sample_sorted"] - n1["sample_sorted"] <= 0:
            raise AssertionError(f"carry on the {name}: no carry round, or "
                                 "a carry round launched K5 otherwise than "
                                 "once in pair mode")
        k5 += n1["sample_sorted"] + n1["sample_sorted2"]
    print("[carry] distances bitwise equal to the non-carry routes, rounds "
          "and edge counts equal, on both graphs")
    times = {False: [], True: []}
    for carry in (False, True, True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sssp_device(dgw, 0, mode="pull", delta=GRID_DELTA, deep_carry=carry)
        torch.cuda.synchronize()
        times[carry].append((time.perf_counter() - t0) * 1e3)
    for carry in (False, True):
        print(f"[timing] sssp grid, deep_carry={carry}: best "
              f"{min(times[carry]):.3f} ms of 3 "
              f"({', '.join(f'{t:.3f}' for t in times[carry])}); on {card}")
    return k5



# Phase 29's graph: the circulant C(n; 1..h), every vertex joined to the
# h vertices on each side of it on the ring, 2^31 edges.
RING_N, RING_H = 1 << 16, 1 << 14
K10_CHECK_CHUNK = 1 << 26


def _k10_equal_in_chunks(words, idx, got) -> int:
    """Hold K10's output ``got`` over ``idx`` against its plain version
    chunk by chunk, carrying the plain running sum across chunks (its
    int64 temporaries would not fit beside a graph of 2^31 edges whole).
    Bitwise; returns the chunks compared."""
    import torch
    from gunrock_tpu_torch.ops import kernels as K
    carry, chunks = 0, 0
    for lo in range(0, idx.shape[0], K10_CHECK_CHUNK):
        hi = min(lo + K10_CHECK_CHUNK, idx.shape[0])
        want = K.bitmask_gather_cumsum_plain(words, idx[lo:hi], start=carry)
        if not torch.equal(got[lo:hi], want):
            raise AssertionError(f"K10 differs from its plain version in "
                                 f"ids {lo}..{hi}")
        carry = int(want[-1])
        chunks += 1
        del want
    return chunks


def phase_sizet64(gtt, g, src, dev, card):
    """Phase 28: the flagship (with phase 11's weights) uploaded
    ``with_csc, with_edge_values, with_edge_src`` twice, with
    ``sizet64=True`` and with int32 offsets. DO-BFS with predecessors
    (K10, K2), SSSP near-far and fused (K5, K7, K8; K3 where a round
    pulls), CC, PageRank's loop route (K3) and BC, hybrid and fused (K5,
    K7, K8), on both: every result bitwise equal across the two uploads,
    or, where a route sums with atomics and two runs on one upload differ
    too, within PERF.md section 2's tolerance. Best of RUNS DO-BFS for
    both, in turns. Returns the launch counts of the sizet64 runs."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.models.bc import bc_device
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.models.cc import cc_device
    from gunrock_tpu_torch.models.pr import pagerank_device
    from gunrock_tpu_torch.models.sssp import sssp_device
    from gunrock_tpu_torch.ops import kernels as K

    kw = dict(with_csc=True, with_edge_values=True, with_edge_src=True,
              device=dev)
    t0 = time.perf_counter()
    d64 = gtt.to_device(g, sizet64=True, **kw)
    d32 = gtt.to_device(g, sizet64=False, **kw)
    torch.cuda.synchronize()
    print(f"[sizet64] flagship uploaded twice in "
          f"{time.perf_counter() - t0:.3f} s: offsets "
          f"{d64.row_offsets.dtype}/{d64.csc_offsets.dtype} and "
          f"{d32.row_offsets.dtype}; ids {d64.col_indices.dtype}, "
          f"{d64.csc_indices.dtype}, {d64.csc_edge_dst.dtype}, "
          f"{d64.edge_src.dtype}")
    if d64.row_offsets.dtype != torch.int64 or \
            d64.csc_offsets.dtype != torch.int64 or \
            d32.row_offsets.dtype != torch.int32:
        raise AssertionError("sizet64 offsets are not int64")
    delta = 32.0 * float(np.mean(g.edge_values))
    runs = {
        "do-bfs preds": lambda d: bfs_device(
            d, src, mark_preds=True, direction_optimized=True)[:2],
        "sssp near-far": lambda d: sssp_device(
            d, src, mark_preds=True, mode="nearfar", delta=delta)[:2],
        "sssp near-far fused": lambda d: sssp_device(
            d, src, mark_preds=True, mode="nearfar", delta=delta,
            fused=True)[:2],
        "cc": lambda d: cc_device(d)[:1],
        "pagerank loop": lambda d: pagerank_device(d)[:1],
        "bc hybrid": lambda d: bc_device(d, src)[:3],
        "bc fused": lambda d: bc_device(d, src, fused=True)[:3],
    }
    # PERF.md section 2: PageRank rtol 1e-3; BC sigma rtol 1e-4, BC rtol
    # 1e-3, atol 1e-3.
    tol = {"pagerank loop": [(1e-3, 0.0)],
           "bc hybrid": [(1e-3, 1e-3), (1e-4, 0.0), (0.0, 0.0)],
           "bc fused": [(1e-3, 1e-3), (1e-4, 0.0), (0.0, 0.0)]}
    launches = {}
    for name, fn in runs.items():
        K.reset_launch_counts()
        got = fn(d64)
        torch.cuda.synchronize()
        n = {k: v for k, v in K.LAUNCHES.items() if v}
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        want = fn(d32)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        how = "bitwise equal"
        if not same:
            again = fn(d32)
            if all(torch.equal(a, b) for a, b in zip(again, want)) or \
                    name not in tol:
                raise AssertionError(f"sizet64 {name} differs from the "
                                     "int32 upload's")
            for (rtol, atol), a, b in zip(tol[name], got, want):
                check_close(f"sizet64 {name}", a.cpu().numpy(),
                            b.cpu().numpy(), rtol=rtol, atol=atol)
            how = ("within PERF.md's tolerance (two runs on the int32 "
                   "upload differ too: atomic sums)")
        print(f"[sizet64] {name}: {how}; kernel launches {n}")
    for name in ("bitmask_gather_cumsum", "bitmask_gather", "sample_sorted2",
                 "reduce_by_dst_sorted", "scatter_sorted", "pull_reduce2"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched on the sizet64 "
                                 "graph")

    def do_bfs(d):
        return lambda: bfs_device(d, src, direction_optimized=True)

    times = {"int32": [], "sizet64": []}
    for d in (d32, d64):
        do_bfs(d)()
    torch.cuda.synchronize()
    for _ in range(RUNS):
        for name, d in (("int32", d32), ("sizet64", d64)):
            t0 = time.perf_counter()
            do_bfs(d)()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in times.items():
        print(f"[sizet64] DO-BFS elapsed_ms best {min(ts):.3f} of {RUNS} on "
              f"the {name} upload ({', '.join(f'{t:.3f}' for t in ts)}), "
              f"in turns; on {card}")
    del d32, d64
    torch.cuda.empty_cache()
    return launches


def _ring_graph():
    """The circulant C(RING_N; 1..RING_H) as padded CSR arrays, each row
    the h predecessors then the h successors on the ring (two ascending
    runs modulo n), built a block of rows at a time with no host sort. It
    is symmetric, so its CSC is its CSR."""
    import numpy as np
    n, h = RING_N, RING_H
    deg = 2 * h
    pattern = np.concatenate([np.arange(-h, 0), np.arange(1, h + 1)]) \
        .astype(np.int32)
    col = np.empty(n * deg, dtype=np.int32)
    rows = col.reshape(n, deg)
    block = 256
    for r0 in range(0, n, block):
        v = np.arange(r0, r0 + block, dtype=np.int32)[:, None]
        np.bitwise_and(v + pattern[None, :], n - 1, out=rows[r0:r0 + block])
    dst = np.empty(n * deg, dtype=np.int32)
    dst.reshape(n, deg)[:] = np.arange(n, dtype=np.int32)[:, None]
    offsets = np.arange(n + 1, dtype=np.int64) * deg
    return {"row_offsets": offsets, "col_indices": col,
            "csc_offsets": offsets, "csc_indices": col,
            "csc_edge_dst": dst}


def phase_past_2_31(gtt, dev, card):
    """Phase 29: a graph past 2^31 edges through the automatic rule. The
    circulant C(2^16; 1..2^14) (2^31 edges, degree 32,768), built in numpy
    and handed to ``from_numpy`` with ``sizet64=None``; DO-BFS with
    predecessors from vertex 0 through ``gtt.bfs``, whose direction vote
    pulls the second level through K10 over all 2^31 CSC ids. Labels
    equal ceil(d / h) (d the ring distance to the source), every
    predecessor lies within ring distance h and one level up; K10 on the
    depth-1 mask over all its ids bitwise equal to its plain version, in
    chunks. Prints the host build, the checks and the upload, peak
    device memory of the upload and of the traversal, the traversal's
    wall time, the host's memory and the card. Returns K10's launches in
    the traversal."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.graph.device import _pad, from_numpy, sizet64_rule
    from gunrock_tpu_torch.ops import kernels as K

    free = subprocess.run(["free", "-g"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"[2^31] host memory (free -g): {' | '.join(free[:2])}")
    n, h = RING_N, RING_H
    t0 = time.perf_counter()
    fields = _ring_graph()
    e = n * 2 * h
    print(f"[2^31] circulant C({n}; 1..{h}): |V|={n} |E|={e}, host build "
          f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    dg = from_numpy(
        fields, num_nodes=n, num_edges=e, v_pad=_pad(n), e_pad=_pad(e),
        undirected=True, device=dev, timings=timings)
    upload_s = time.perf_counter() - t0
    up_peak = torch.cuda.max_memory_allocated()
    del fields
    print(f"[2^31] from_numpy {upload_s:.3f} s (host checks "
          f"{timings['check_s']:.3f} s, upload {timings['upload_s']:.3f} "
          f"s); e_pad {dg.e_pad} (the rule's bound 2^31 - 2 alone picks "
          f"sizet64: {sizet64_rule(dg.e_pad, None)}), "
          f"offsets {dg.row_offsets.dtype}/{dg.csc_offsets.dtype}, ids "
          f"{dg.col_indices.dtype}; peak device memory "
          f"{up_peak / 2**30:.3f} GiB")
    if not dg.sizet64 or dg.csc_offsets.dtype != torch.int64:
        raise AssertionError("the automatic rule did not pick int64 offsets")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = gtt.bfs(dg, 0, mark_preds=True, direction_optimized=True,
                  instrumented=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    bfs_peak = torch.cuda.max_memory_allocated()
    phases = [r["phase"] for r in res.info["per_iteration"]]
    levels_ms = sum(r["ms"] for r in res.info["per_iteration"])
    print(f"[2^31] DO-BFS with preds from 0: {wall:.3f} s wall "
          f"(process {res.info['process_ms']:.3f} ms, of which the levels "
          f"{levels_ms:.3f} and the predecessor fill and reads the rest); "
          f"levels "
          + ", ".join(f"{r['iteration']}:{r['phase']}(n={r['frontier']}, "
                      f"{r['ms']:.3f} ms)" for r in res.info["per_iteration"])
          + f"; K10 launches {launches['bitmask_gather_cumsum']}, K2 "
          f"{launches['bitmask_gather']}; peak device memory "
          f"{bfs_peak / 2**30:.3f} GiB; on {card}")
    if launches["bitmask_gather_cumsum"] <= 0 or "pull" not in phases:
        raise AssertionError("the second level did not pull through K10")
    v = np.arange(n)
    d = np.minimum(v, n - v)
    want = -(-d // h)
    if not np.array_equal(res.labels, want):
        raise AssertionError(f"{int((res.labels != want).sum())} labels "
                             "differ from ceil(d / h)")
    p = res.preds.astype(np.int64)
    if p[0] != -1 or (p[1:] < 0).any():
        raise AssertionError("a predecessor is missing or set at the source")
    ring = np.abs(p[1:] - v[1:])
    ring = np.minimum(ring, n - ring)
    if (ring > h).any() or (ring == 0).any() or \
            (want[p[1:]] != want[1:] - 1).any():
        raise AssertionError("a predecessor is not an in-neighbour one "
                             "level up")
    print("[2^31] labels equal ceil(d / h); predecessors valid")
    # The depth-1 mask (2^30 hits), then every vertex (2^31 hits: the
    # last sum wraps to -2^31).
    for name, mask in (("depth-1", want == 1), ("all-vertices", want >= 0)):
        words = K.pack_bitmask(torch.from_numpy(mask).to(dev))
        got = K.bitmask_gather_cumsum(words, dg.csc_indices)
        t0 = time.perf_counter()
        chunks = _k10_equal_in_chunks(words, dg.csc_indices, got)
        last = int(got[-1])
        print(f"[2^31] K10 over all {dg.csc_indices.shape[0]} ids at the "
              f"{name} mask ({int(mask.sum())} bits): bitwise equal to its "
              f"plain version in {chunks} chunks "
              f"({time.perf_counter() - t0:.3f} s); last sum {last} "
              f"({last % 2**32} hits mod 2^32)")
        del got
    del dg
    torch.cuda.empty_cache()
    return launches["bitmask_gather_cumsum"]



def phase_capi(gtt, g, src, bfs_labels, card):
    """Phase 30: the C ABI on the card and ``rmat_device``. Builds the
    shim (``gunrock_tpu_torch.capi.build_capi_lib``), compiles
    ``examples/capi_example_torch.c`` against it with gcc and runs it:
    CC, BFS, SSSP, PageRank and BC on the 7-vertex graph, checked by the
    program; then its BFS on the flagship, read from raw int32 files,
    whose labels must equal phase 3's (``gtt.bfs``). Then
    ``rmat_device(scale=20, edge_factor=32)`` on the card: ids in range,
    edge count, degree statistics and quadrant shares beside the host
    generator's COO (``rmat_coo``), the shares within 0.005."""
    import numpy as np
    import torch
    from gunrock_tpu_torch.capi import CAPI_HEADER_DIR, build_capi_lib
    from gunrock_tpu_torch.graph.native import build_dir

    t0 = time.perf_counter()
    so = build_capi_lib()
    work = os.path.join(build_dir(), "capi")
    os.makedirs(work, exist_ok=True)
    exe = os.path.join(work, "capi_example_torch")
    root = os.path.dirname(os.path.abspath(__file__))
    subprocess.run(["gcc", os.path.join(root, "examples",
                                        "capi_example_torch.c"),
                    "-o", exe, f"-I{CAPI_HEADER_DIR}", so, "-lm"],
                   check=True, capture_output=True, text=True)
    print(f"[capi] shim {os.path.relpath(so, root)} and the C consumer "
          f"built in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    r = subprocess.run([exe], capture_output=True, text=True, timeout=600)
    for line in r.stdout.splitlines():
        print(f"[capi] {line}")
    if r.returncode != 0 or "ALL OK" not in r.stdout:
        raise AssertionError(f"capi_example_torch failed ({r.returncode}): "
                             f"{r.stderr[-2000:]}")
    print(f"[capi] 7-vertex graph: CC, BFS, SSSP, PageRank, BC checked by "
          f"the C program ({time.perf_counter() - t0:.3f} s)")
    files = [os.path.join(work, f"{k}.bin") for k in ("row", "col", "labels")]
    g.row_offsets.astype(np.int32).tofile(files[0])
    g.col_indices.astype(np.int32).tofile(files[1])
    t0 = time.perf_counter()
    r = subprocess.run([exe, files[0], files[1], str(g.num_nodes),
                        str(g.num_edges), str(src), files[2]],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"capi_example_torch BFS failed "
                             f"({r.returncode}): {r.stderr[-2000:]}")
    labels = np.fromfile(files[2], dtype=np.int32)
    for f in files:
        os.remove(f)
    if not np.array_equal(labels, bfs_labels):
        raise AssertionError(f"{int((labels != bfs_labels).sum())} labels "
                             "through the C ABI differ from gtt.bfs's")
    print(f"[capi] {r.stdout.strip()}; labels equal phase 3's "
          f"({time.perf_counter() - t0:.3f} s with the process start) on "
          f"{card}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, src_d, dst_d = gtt.io.rmat_device(SCALE, EDGE_FACTOR, seed=SEED,
                                         device="cuda")
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, src_h, dst_h = gtt.io.rmat_coo(SCALE, EDGE_FACTOR, seed=SEED)
    host_s = time.perf_counter() - t0
    if int(src_d.min()) < 0 or int(src_d.max()) >= n or \
            int(dst_d.min()) < 0 or int(dst_d.max()) >= n:
        raise AssertionError("rmat_device ids out of range")

    def stats(deg, s, d):
        bits = torch.arange(SCALE, device=s.device)
        q = torch.zeros(4, dtype=torch.int64, device=s.device)
        step = 1 << 22
        for k in range(0, s.shape[0], step):
            sb = (s[k:k + step, None].long() >> bits) & 1
            db = (d[k:k + step, None].long() >> bits) & 1
            q += torch.bincount((2 * sb + db).flatten(), minlength=4)
        shares = (q.double() / q.sum()).tolist()
        return {"edges": int(s.shape[0]), "max_deg": int(deg.max()),
                "mean_deg": float(deg.double().mean()),
                "zero_deg": float((deg == 0).double().mean()),
                "shares": [round(x, 5) for x in shares]}

    dev_stats = stats(torch.bincount(src_d.long(), minlength=n), src_d, dst_d)
    # the host generator's edges, counted on the card as well
    sh, dh = torch.from_numpy(src_h).cuda(), torch.from_numpy(dst_h).cuda()
    host_stats = stats(torch.bincount(sh, minlength=n), sh, dh)
    print(f"[rmat_device] n{SCALE} e{EDGE_FACTOR} seed {SEED} on the card "
          f"in {draw_ms:.3f} ms: {dev_stats}; host rmat_coo in "
          f"{host_s:.3f} s: {host_stats} (the host CSR after dedup and "
          f"symmetry: {g.num_edges} edges)")
    if max(abs(a - b) for a, b in zip(dev_stats["shares"],
                                      host_stats["shares"])) > 0.005:
        raise AssertionError("rmat_device's quadrant shares differ from "
                             "the host generator's")
    del src_d, dst_d


# Phase 31's shard count and its second graph: the other partition
# methods, WTF, TopK and TC run on R-MAT at this scale (the flagship's
# multilevel partition and TC would take too long).
SHARDS, SHARD_SMALL_SCALE = 4, 16


def _shard_run(K, launches, fn):
    """Drive ``fn`` once with the launch counts set to 0 just before and
    read just after (summed into ``launches``); returns ``(out, ms,
    run)``: its result, its fenced wall time and its own counts."""
    import torch
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    run = dict(K.LAUNCHES)
    for k, v in run.items():
        launches[k] = launches.get(k, 0) + v
    return out, ms, run


def _shard_report(name, ms, steps, comm, run, card):
    used = {k: v for k, v in run.items() if v}
    print(f"[sharded] {name}: process {ms:.3f} ms, supersteps {steps}, "
          f"comm_bytes {comm}, K1 launches {run['pull_reached_words']}, "
          f"K3 launches {run['pull_reduce2']}, all launches {used}; on "
          f"{card}")


def _old_ids(perm, t, n):
    """A relabeled (p*S,) result in original vertex ids."""
    return t.cpu().numpy()[perm][:n]


def _old_preds(perm, preds, n):
    import numpy as np
    inv = np.full(preds.shape[0], -1, np.int64)
    inv[perm] = np.arange(n)
    p = preds.cpu().numpy()[perm]
    return np.where(p >= 0, inv[np.maximum(p, 0)], -1).astype(np.int32)


def _shard_kernels(K, P, glob, compact, words_by_level, tables, card):
    """K1 on every shard's global view at the sharded DO-BFS's pull
    levels; K3 min/add and sum/mul on every shard's compact table; each
    against its plain version: equal (K3's sums within rel 1e-5, as phase
    9 holds them), bitwise over two launches, median times summed over
    the shards. Returns the numbers for K1's and K3's JSON entries."""
    import torch
    k1 = {"shard_ms": 0.0, "shard_plain_ms": 0.0, "shard_max_abs_err": 0}
    for d, words in words_by_level.items():
        ms = plain = 0.0
        for view in glob.views:
            got = K.pull_reached_words(words, view)
            want = K.pull_reached_words_plain(words, view)
            torch.cuda.synchronize()
            k1["shard_max_abs_err"] = max(k1["shard_max_abs_err"],
                                          _max_abs_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K1 on a shard view differs from its "
                                     f"plain version at level {d}")
            ms += _median_ms(lambda: K.pull_reached_words(words, view))
            plain += _median_ms(
                lambda: K.pull_reached_words_plain(words, view), reps=5)
        k1["shard_ms"] += ms
        k1["shard_plain_ms"] += plain
        # each shard's csc_indices and csc_offsets, the words, its reach
        k1["shard_bound_ms"] = k1.get("shard_bound_ms", 0.0) + sum(
            bound(4 * v.num_edges + 4 * (v.v_pad + 1) + 4 * words.shape[0]
                  + v.v_pad // 8)["bound_ms"] for v in glob.views)
        print(f"[sharded] K1 on the {len(glob.views)} shard views at pull "
              f"level {d}: equal, {ms:.4f} ms vs plain {plain:.4f} ms "
              f"(bound summed over the levels so far "
              f"{k1['shard_bound_ms']:.4f} ms); on {card}")
    k3 = {"compact_max_abs_err": 0.0, "compact_max_rel_err": 0.0}
    for name, op, wmode in (("min_add", "min", "add"),
                            ("sum_mul", "sum", "mul")):
        table, views = tables[name], compact[name]
        ms = plain = rel = 0.0
        for i, view in enumerate(views.views):
            got = P.pull_reduce2(table[i], view, op=op, wmode=wmode)
            again = P.pull_reduce2(table[i], view, op=op, wmode=wmode)
            want = P.pull_reduce2_plain(table[i], view, op=op, wmode=wmode)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K3 {name} on a compact table: two "
                                     "launches differ")
            if op == "min" and not torch.equal(got, want):
                raise AssertionError("K3 min on a compact table differs "
                                     "from its plain version")
            abs_err, rel_err = _errs(got, want)
            if rel_err > 1e-5:
                raise AssertionError(f"K3 {name} on a compact table: max "
                                     f"rel err {rel_err:.3e}")
            rel = max(rel, rel_err)
            k3["compact_max_abs_err"] = max(k3["compact_max_abs_err"],
                                            abs_err)
            ms += _median_ms(lambda: P.pull_reduce2(table[i], view, op=op,
                                                    wmode=wmode))
            plain += _median_ms(lambda: P.pull_reduce2_plain(
                table[i], view, op=op, wmode=wmode), reps=5)
        k3["compact_max_rel_err"] = max(k3["compact_max_rel_err"], rel)
        # ids and weights an edge; offsets, table and output a shard
        k3[f"compact_{name}_bound_ms"] = sum(
            bound(pull_bytes(v.num_edges, v.v_pad, 2, edge_streams=2)
                  + 4 * v.n_values, v.num_edges)["bound_ms"]
            for v in views.views)
        k3[f"compact_{name}_ms"] = ms
        k3[f"compact_{name}_plain_ms"] = plain
        print(f"[sharded] K3 {name} on the {len(views.views)} compact "
              f"tables ({views.src_pad} values over {views.dst_pad} rows "
              f"each): bitwise over two launches, max rel err {rel:.3e} "
              f"against the plain version, {ms:.4f} ms vs plain "
              f"{plain:.4f} ms, bound {k3[f'compact_{name}_bound_ms']:.4f} "
              f"ms; on {card}")
    return k1, k3


def phase_sharded(gtt, g, src, bfs_labels, dist, card, dev):
    """Phase 31: the sharded zoo on 4 shards of the card (see the module
    docstring). Returns ``(launches, k1, k3)``: the kernel launches of
    every driven run, and K1's and K3's shard numbers."""
    import numpy as np
    import torch
    from gunrock_tpu_torch import parallel as SP
    from gunrock_tpu_torch.models.bfs import bfs_device
    from gunrock_tpu_torch.ops import kernels as K
    from gunrock_tpu_torch.ops import pull2 as P
    from gunrock_tpu_torch.parallel.blocked import blocked_from_partition
    from gunrock_tpu_torch.parallel.hits import link_sharded_device

    t_phase = time.perf_counter()
    mesh = SP.make_mesh(SHARDS, device=dev)
    n = g.num_nodes
    launches = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pg, perm = SP.partition(g, SHARDS, method="random", with_csc=True,
                            with_ghosts=True, with_edge_values=True,
                            device=dev)
    torch.cuda.synchronize()
    print(f"[sharded] partition 'random' of rmat n{SCALE} e{EDGE_FACTOR} "
          f"into {SHARDS} shards of {dev} (with_csc, with_ghosts, "
          f"with_edge_values): {time.perf_counter() - t0:.3f} s; S "
          f"{pg.shard_size}, e_shard_pad {pg.e_shard_pad}, ghost_cap "
          f"{pg.ghost_cap}, fwd_ghost_cap {pg.fwd_ghost_cap}; on {card}")
    t0 = time.perf_counter()
    V = pg.v_global_pad
    src_new = int(perm[src])
    vmask = np.zeros(V, bool)
    vmask[perm] = True
    vmask = torch.from_numpy(vmask).to(dev)
    out_deg = np.zeros(V, np.float32)
    out_deg[perm] = np.diff(g.row_offsets).astype(np.float32)
    out_deg = torch.from_numpy(out_deg).to(dev)
    inv_deg = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    glob = blocked_from_partition(pg)
    compact = {"sum_mul": blocked_from_partition(
        pg, compact=True, edge_weight=lambda sg, dl, i: inv_deg[sg]),
        "min_add": blocked_from_partition(pg, compact=True,
                                          edge_weight="csc")}
    torch.cuda.synchronize()
    print(f"[sharded] shard views (global, compact with 1/outdeg, compact "
          f"with the weights): {time.perf_counter() - t0:.3f} s")

    # DO-BFS through K1, and non-DO BFS, with predecessors.
    (lab, preds, iters, _, ovf, comm, trace), ms, run = _shard_run(
        K, launches, lambda: SP.bfs_sharded_device(
            pg, src_new, mesh=mesh, mark_preds=True,
            direction_optimized=True, blocked=glob))
    _shard_report("DO-BFS (K1 a shard a pull)", ms, iters, float(comm), run,
                  card)
    pulls = [d + 1 for d in range(iters) if trace[d] == 1]
    print(f"[sharded] DO-BFS direction trace {trace[:iters].tolist()}")
    if ovf or not pulls or run["pull_reached_words"] != SHARDS * len(pulls):
        raise AssertionError(f"sharded DO-BFS: {run['pull_reached_words']} "
                             f"K1 launches for pull levels {pulls}")
    labels_do = _old_ids(perm, lab, n)
    if not np.array_equal(labels_do, bfs_labels):
        raise AssertionError("sharded DO-BFS labels differ from phase 3's")
    check_preds(g, src, labels_do, _old_preds(perm, preds, n))
    lab_new = lab
    (lab, preds, iters, _, ovf, comm, _), ms, run = _shard_run(
        K, launches, lambda: SP.bfs_sharded_device(pg, src_new, mesh=mesh,
                                                   mark_preds=True))
    _shard_report("non-DO BFS", ms, iters, float(comm), run, card)
    labels = _old_ids(perm, lab, n)
    if ovf or not np.array_equal(labels, bfs_labels):
        raise AssertionError("sharded BFS labels differ from phase 3's")
    check_preds(g, src, labels, _old_preds(perm, preds, n))
    print("[sharded] both BFS runs: labels equal phase 3's (scipy's "
          "depths), predecessors valid")

    # PageRank through K3 sum/mul, 20 iterations at threshold 0.
    (rank, iters), ms, run = _shard_run(
        K, launches, lambda: SP.pagerank_sharded_device(
            pg, mesh=mesh, out_degrees_new=out_deg, vmask_new=vmask,
            max_iters=PR_ITERS, threshold=0.0, blocked=compact["sum_mul"]))
    step_bytes = SHARDS * (SHARDS - 1) * pg.ghost_cap * 4
    _shard_report("PageRank (K3 sum a shard)", ms, iters, step_bytes * iters,
                  run, card)
    if run["pull_reduce2"] != SHARDS * iters:
        raise AssertionError("sharded PageRank: K3 not launched once a "
                             "shard an iteration")
    one = gtt.pagerank(g, max_iters=PR_ITERS, threshold=0.0, device=dev)
    check_close("sharded pagerank vs single-card loop route",
                _old_ids(perm, rank, n), one.ranks, rtol=1e-4, atol=0.0)
    pr_table = SP.ghost_exchange(rank.view(SHARDS, -1), pg.ghost_send_idx)

    # SSSP near-far with the pull-relax through K3 min/add.
    delta = 32.0 * float(np.mean(g.edge_values))
    (dist_new, iters, ovf, comm), ms, run = _shard_run(
        K, launches, lambda: SP.sssp_sharded_device(
            pg, src_new, mesh=mesh, mode="nearfar", delta=delta,
            blocked=compact["min_add"]))
    _shard_report("SSSP near-far (K3 min a shard a pull)", ms, iters,
                  float(comm), run, card)
    if ovf or run["pull_reduce2"] <= 0 or run["pull_reduce2"] % SHARDS:
        raise AssertionError(f"sharded SSSP: {run['pull_reduce2']} K3 "
                             "launches")
    ref = dist[:n].cpu().numpy()
    if not np.array_equal(_old_ids(perm, dist_new, n), ref):
        raise AssertionError("sharded SSSP distances differ from phase "
                             "11's")
    print(f"[sharded] SSSP distances bitwise equal phase 11's (Dijkstra "
          f"within rtol 1e-5); {run['pull_reduce2'] // SHARDS} pull "
          f"supersteps")
    frontier = (torch.rand(V, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED)) < 0.3) & vmask
    sssp_table = SP.ghost_exchange(
        torch.where(frontier, dist_new, float("inf")).view(SHARDS, -1),
        pg.ghost_send_idx)

    # CC, BC from the hub, HITS and SALSA.
    (comp, iters), ms, run = _shard_run(
        K, launches, lambda: SP.cc_sharded_device(pg, mesh=mesh,
                                                  vmask_new=vmask))
    _shard_report("CC", ms, iters, SHARDS * (SHARDS - 1) * pg.fwd_ghost_cap
                  * 4 * iters, run, card)
    inv = np.zeros(V, np.int64)
    inv[perm] = np.arange(n)
    rep = inv[_old_ids(perm, comp, n)]
    mins = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(mins, rep, np.arange(n))
    one = gtt.cc(g, device=dev)
    if not np.array_equal(mins[rep].astype(np.int32), one.components):
        raise AssertionError("sharded CC differs from the single-card CC")
    (bcv, sig, blab, depth), ms, run = _shard_run(
        K, launches, lambda: SP.bc_sharded_device(pg, src_new, mesh=mesh))
    # BC's exchanges: a label table a BFS level and a sigma table a
    # forward level (in-edge ghosts), a delta table a backward level
    # (out-edge ghosts), and the fixed labels and sigmas once.
    _shard_report("BC from the hub", ms, 3 * depth, SHARDS * (SHARDS - 1)
                  * 4 * ((2 * depth + 1) * pg.ghost_cap
                         + (depth + 2) * pg.fwd_ghost_cap), run, card)
    one = gtt.bc(g, src, device=dev)
    if not np.array_equal(_old_ids(perm, blab, n), one.labels):
        raise AssertionError("sharded BC labels differ")
    check_close("sharded bc sigma vs single card", _old_ids(perm, sig, n),
                one.sigmas, rtol=1e-4, atol=0.0)
    check_close("sharded bc vs single card", 0.5 * _old_ids(perm, bcv, n),
                one.bc_values, rtol=1e-3, atol=1e-3)
    for kind, atol in (("hits", 1e-4), ("salsa", 1e-5)):
        (hub, auth), ms, run = _shard_run(
            K, launches, lambda: link_sharded_device(
                pg, kind, vmask_new=vmask, max_iters=LINK_ITERS, mesh=mesh))
        _shard_report(kind, ms, LINK_ITERS, SHARDS * (SHARDS - 1) * (
            pg.ghost_cap + pg.fwd_ghost_cap) * 4 * LINK_ITERS, run, card)
        one = getattr(gtt, kind)(g, max_iters=LINK_ITERS, device=dev)
        check_close(f"sharded {kind} hubs vs single card",
                    _old_ids(perm, hub, n), one.hubs, rtol=1e-3, atol=atol)
        check_close(f"sharded {kind} auths vs single card",
                    _old_ids(perm, auth, n), one.auths, rtol=1e-3,
                    atol=atol)

    # bfs_batch: 4 sources on the 4 shards, each a single-card loop.
    rng = np.random.default_rng(SEED)
    sources = [src] + rng.choice(np.nonzero(np.diff(g.row_offsets))[0], 3,
                                 replace=False).tolist()
    batch, ms, run = _shard_run(K, launches,
                                lambda: SP.bfs_batch(g, sources, mesh=mesh))
    _shard_report(f"bfs_batch {sources}", ms, "-", 0, run, card)
    if not np.array_equal(batch.labels[0], bfs_labels):
        raise AssertionError("bfs_batch's hub row differs from phase 3's")
    for row, s in zip(batch.labels[1:], sources[1:]):
        lab_s = SP.bfs_sharded_device(pg, int(perm[s]), mesh=mesh,
                                      direction_optimized=True,
                                      blocked=glob)[0]
        if not np.array_equal(row, _old_ids(perm, lab_s, n)):
            raise AssertionError(f"bfs_batch row of {s} differs from the "
                                 "sharded DO-BFS")
    print("[sharded] bfs_batch: the hub's row equals phase 3's, the others "
          "the sharded DO-BFS's")

    # The kernels at these shapes against their plain versions.
    words = {d: K.pack_bitmask(lab_new == d - 1) for d in pulls}
    k1, k3 = _shard_kernels(K, P, glob, compact, words,
                            {"sum_mul": pr_table, "min_add": sssp_table},
                            card)
    del pg, glob, compact, pr_table, sssp_table
    torch.cuda.empty_cache()
    print(f"[sharded] the flagship's part: {time.perf_counter() - t_phase:.3f} "
          f"s")

    # R-MAT scale 16: WTF, TopK, TC and every partition method.
    g16 = gtt.io.rmat(scale=SHARD_SMALL_SCALE, edge_factor=16, seed=SEED,
                      undirected=True)
    s16 = g16.largest_degree_vertex()
    res, ms, run = _shard_run(K, launches, lambda: SP.wtf_sharded(
        g16, s16, mesh=mesh))
    _shard_report(f"wtf, rmat n{SHARD_SMALL_SCALE}", res.info["process_ms"],
                  res.info["ppr_iterations"], res.info[
                      "comm_bytes_per_superstep"], run, card)
    one = gtt.wtf(g16, s16, device=dev)
    check_close("sharded wtf ppr vs single card", res.ppr_ranks,
                one.ppr_ranks, rtol=1e-3, atol=1e-6)
    check_close("sharded wtf sorted scores vs single card",
                np.sort(res.scores)[::-1], np.sort(one.scores)[::-1],
                rtol=1e-3, atol=1e-6)
    res, ms, run = _shard_run(K, launches, lambda: SP.topk_sharded(
        g16, k=10, mesh=mesh))
    _shard_report(f"topk, rmat n{SHARD_SMALL_SCALE}", res.info["process_ms"],
                  1, res.info["comm_bytes_per_superstep"], run, card)
    cent = np.diff(g16.row_offsets) + np.bincount(g16.col_indices,
                                                  minlength=g16.num_nodes)
    if not (np.array_equal(res.centralities, np.sort(cent)[::-1][:10])
            and np.array_equal(cent[res.node_ids], res.centralities)):
        raise AssertionError("sharded topk differs from numpy's degrees")
    res, ms, run = _shard_run(K, launches, lambda: SP.tc_sharded(
        g16, mesh=mesh))
    _shard_report(f"tc, rmat n{SHARD_SMALL_SCALE}, {res.info['num_chunks']} "
                  f"chunks", res.info["process_ms"], res.info["num_chunks"],
                  0, run, card)
    one = gtt.tc(g16, device=dev)
    if res.total != one.total or not np.array_equal(res.vertex_counts,
                                                    one.vertex_counts):
        raise AssertionError("sharded tc differs from the single card")
    print(f"[sharded] wtf, topk, tc on rmat n{SHARD_SMALL_SCALE}: equal to "
          f"the single card ({res.total} triangles)")
    dg16 = gtt.to_device(g16, with_csc=True, device=dev)
    lab16 = bfs_device(dg16, s16, direction_optimized=True)[0][
        :g16.num_nodes].cpu().numpy()
    for method in ("static", "random", "biasrandom", "cluster", "metis", "lp",
                   "duplicate"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pgm, pm = SP.partition(g16, SHARDS, method=method, seed=SEED,
                               with_csc=True, device=dev)
        torch.cuda.synchronize()
        part_s = time.perf_counter() - t0
        views = blocked_from_partition(pgm)
        (lab, _, iters, _, _, comm, _), ms, run = _shard_run(
            K, launches, lambda: SP.bfs_sharded_device(
                pgm, int(pm[s16]), mesh=mesh, direction_optimized=True,
                blocked=views))
        cut = SP.boundary_fraction(g16, pm // pgm.shard_size)
        print(f"[sharded] partition '{method}' of rmat n{SHARD_SMALL_SCALE}: "
              f"{part_s:.3f} s, boundary fraction {cut:.4f}; DO-BFS process "
              f"{ms:.3f} ms, supersteps {iters}, comm_bytes {float(comm)}, "
              f"K1 launches {run['pull_reached_words']}; on {card}")
        if run["pull_reached_words"] <= 0 or not np.array_equal(
                _old_ids(pm, lab, g16.num_nodes), lab16):
            raise AssertionError(f"sharded DO-BFS on the '{method}' "
                                 "partition differs or launched no K1")
    print(f"[sharded] phase 31 in {time.perf_counter() - t_phase:.3f} s; "
          f"launches {launches}; on {card}")
    return launches, k1, k3


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

    # 4. Kernels against their plain versions at the main path's shapes,
    # on the graph as bench.py uploads it (with the blocked CSC: K1).
    dg = dgb = gtt.to_device(g, with_csc=True, with_blocked_csc=True,
                             device=dev)
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
    k2 = phase_k2_kernel(dg, src, labels, rng, dev)
    # K1 a pull level: csc_indices, csc_offsets, the frontier and reach
    # words (csc_edge_dst is not needed: the rows follow from the
    # offsets).
    k1_work = bound(len(pull_levels) * (4 * dg.num_edges + 4 * (dg.v_pad + 1)
                                        + dg.v_pad // 4))
    k1_old = bound(len(pull_levels) * (8 * dg.num_edges + dg.v_pad // 4))
    print(f"[kernels] K1 summed over the main path's pull levels "
          f"{sorted(pull_levels)}: {k1_ms:.4f} ms vs plain "
          f"{k1_plain_ms:.4f} ms; bound {k1_work['bound_ms']:.4f} ms (the "
          f"two edge streams counted before: {k1_old['bound_ms']:.4f})")

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
    # K1's device time, profiled after the timed traversals.
    pull_words = [K.pack_bitmask(masks[name]) for name in sorted(pull_levels)]
    k1_device = _device_ms(
        lambda: [K.pull_reached_words(w, dg) for w in pull_words])
    print(f"[kernels] K1 device time summed over the main path's pull "
          f"levels: {k1_device:.4f} ms")

    # 6-7. PageRank; 8. HITS and SALSA; 9. K3/K4 against their plain
    # versions; 10. timing of the value primitives.
    dg, power_launches, loop_launches = phase_pagerank(gtt, g, dev)
    link_launches = phase_link_analysis(gtt, g)
    k3, k4 = phase_value_kernels(dg, dev)
    phase_value_timing(dg, card)
    dgv = dg  # phase 25 runs WTF on it

    # 11-12. SSSP; 13. the grid and non-DO BFS; 14. K5-K8 against their
    # plain versions; 15. timing.
    dgs, dist, sssp_launches = phase_sssp(gtt, g, src, dev, card)
    gg, dgw = phase_grid(gtt, g, src, dgs, res.labels, dev)
    sk = phase_sssp_kernels(dgs, src, dist, dev)
    phase_sssp_timing(g, src, dgs, gg, dgw, card)

    # 16-17. BC; 18. CC; 19. K9 against its plain version; 20. timing.
    bc_launches = phase_bc(gtt, g, src, dgs, res.labels)
    dgc, cc_launches = phase_cc(gtt, g, dev)
    k9 = phase_bc_kernels(dgs, src, dev)
    phase_bc_timing(g, src, dgs, dgc, card)
    del dgc

    # 21. The rest of BFS: K10 and the deep micro-loop; 22. K10 against
    # its plain version; 23. timing.
    dgk, pull_depths, k10_launches = phase_bfs_rest(gtt, g, src, res.labels,
                                                    gg, dgw, dev)
    k10 = phase_k10_kernel(dgk, res.labels, pull_depths, dev)
    phase_bfs_timing(src, info["edges_visited"], dgb, dgk, gg, dgw, card)
    del dgk, dgb

    # 24. K1 and K10 above the shared-memory cap.
    phase_above_cap(gtt, dev)

    # 25. WTF and TopK.
    wtf_launches = phase_wtf_topk(gtt, g, src, dgv, card)

    # 26. TC, sample and the rest of the operators; 27. SSSP's value-carry
    # micro-loop.
    phase_tc(gtt, g, src, res.labels, dgv, card)
    carry_launches = phase_sssp_carry(g, src, dgs, dist, dgw, card)
    del dgw, dgs, dgv, dg
    torch.cuda.empty_cache()

    # 28. The flagship forced to sizet64; 29. a graph past 2^31 edges.
    s64 = phase_sizet64(gtt, g, src, dev, card)
    ring_k10 = phase_past_2_31(gtt, dev, card)

    # 30. The C ABI on the card, and rmat_device.
    phase_capi(gtt, g, src, res.labels, card)

    # 31. The sharded zoo on 4 shards of the card.
    sh, k1_shard, k3_compact = phase_sharded(gtt, g, src, res.labels, dist,
                                             card, dev)

    source = "gunrock_tpu_torch/csrc/bfs_kernels.cu"
    pull_source = "gunrock_tpu_torch/csrc/pull_kernels.cu"
    sssp_source = "gunrock_tpu_torch/csrc/sssp_kernels.cu"
    print(json.dumps({"kernels": [
        {"name": "pull_reached_words", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:257",
         "launches": launches["pull_reached_words"]
         + sh["pull_reached_words"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "library_ms": None,
         "device_ms": k1_device, **k1_work, **k1_shard},
        {"name": "bitmask_gather", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:71",
         "launches": launches["bitmask_gather"]
         + s64.get("bitmask_gather", 0) + sh["bitmask_gather"], **k2},
        {"name": "pull_reduce2", "route": "cuda", "source": pull_source,
         "replaces": "gunrock_tpu/ops/pull2.py:57",
         "launches": loop_launches["pull_reduce2"] + link_launches
         + sssp_launches["pull_reduce2"] + bc_launches["pull_reduce2"]
         + cc_launches["pull_reduce2"] + wtf_launches
         + s64.get("pull_reduce2", 0) + sh["pull_reduce2"], **k3,
         **k3_compact},
        {"name": "pull_power_iters", "route": "cuda", "source": pull_source,
         "replaces": "gunrock_tpu/ops/pull2.py:605",
         "launches": power_launches["pull_power_iters"]
         + sh["pull_power_iters"], **k4},
        {"name": "sample_sorted", "route": "cuda", "source": sssp_source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:594",
         "launches": sssp_launches["sample_sorted"]
         + sssp_launches["sample_sorted2"] + bc_launches["sample_sorted"]
         + carry_launches + s64.get("sample_sorted", 0)
         + s64.get("sample_sorted2", 0) + sh["sample_sorted"]
         + sh["sample_sorted2"],
         **sk["sample_sorted"]},
        {"name": "pull_min_sweeps", "route": "cuda", "source": pull_source,
         "replaces": "gunrock_tpu/ops/pull2.py:323",
         "launches": sssp_launches["pull_min_sweeps"]
         + cc_launches["pull_min_sweeps"] + sh["pull_min_sweeps"],
         **sk["pull_min_sweeps"]},
        {"name": "reduce_by_dst_sorted", "route": "cuda",
         "source": sssp_source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:949",
         "launches": sssp_launches["reduce_by_dst_sorted"]
         + bc_launches["reduce_by_dst_sorted"]
         + s64.get("reduce_by_dst_sorted", 0) + sh["reduce_by_dst_sorted"],
         **sk["reduce_by_dst_sorted"]},
        {"name": "scatter_sorted", "route": "cuda", "source": sssp_source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:1151",
         "launches": sssp_launches["scatter_sorted"]
         + bc_launches["scatter_sorted"] + s64.get("scatter_sorted", 0)
         + sh["scatter_sorted"],
         **sk["scatter_sorted"]},
        {"name": "brandes_levels", "route": "cuda", "source": pull_source,
         "replaces": "gunrock_tpu/ops/pull2.py:895",
         "launches": bc_launches["brandes_levels"]
         + sh["brandes_levels"], **k9},
        {"name": "bitmask_gather_cumsum", "route": "cuda", "source": source,
         "replaces": "gunrock_tpu/ops/pallas_kernels.py:829",
         "launches": k10_launches + s64["bitmask_gather_cumsum"]
         + ring_k10 + sh["bitmask_gather_cumsum"], **k10},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
