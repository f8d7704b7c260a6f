"""On-demand profiles of the port's routes and kernels on the card, and
the timers ``chip_smoke.py`` shares with them.

    python -m gunrock_tpu_torch.tools.card_profile [--scale 20]
        [--edge-factor 32] [--grid-side 1024] [--shards 4] [--runs 3]
        [--reps 20] [--winners 135241] [--device cuda] [--only WORD ...]

The graphs are ``chip_smoke.py``'s: R-MAT (``--scale``, ``--edge-factor``,
seed 1, undirected, ``random_edge_values(seed=7)``) from its hub (its
largest degree), the ``--grid-side`` grid (``random_edge_values(seed=1)``)
from 0, and the R-MAT in ``--shards`` shards cut as phase 31 cuts it,
each built when a selected case first needs it. ``--only`` keeps the
cases whose group or name holds one of its words (``K1`` keeps K1, K10
and K10L1, ``"K1 " "K10 "`` the wrappers). The groups measure:

  * ``value`` (PageRank's two routes, HITS, WTF): wall, device time and
    busy share (device / wall) a run of ``--runs``, every device event;
  * ``sssp`` (SSSP's routes, BFS on the R-MAT and the grid, BC's hybrid
    routes): the best of ``--runs`` fenced runs (one on the grid, whose
    runs the host bounds), then the profile of as many, 12 events;
  * ``pull`` (each kernel at the flagship's shapes, beside its library
    call where there is one; lines ``[profile_pull]``): ``host``, the
    median time until a call returns unfenced, ``call``, the median time
    of a call between two CUDA events (``chip_smoke.py``'s ``ms``), and
    the profile of ``--reps`` calls, K1's a launch and K4's by part; on
    the card, K8's host path in three cuts;
  * ``sharded`` (DO-BFS through K1, non-DO BFS and SSSP near-far through
    K3 on the shards, as phase 31 calls them): the median, least and
    largest of ``--reps`` fenced runs, the supersteps, a digest of the
    result (equal digests, equal bits), the host reads of a run and the
    ATen operators and device events of a profiled one;
  * ``tc``: TC's device time in its first 5 chunks by step, and the
    profile of a whole run.

Without device events (on the CPU) device and busy are "not measured".
To compare two trees in one call, unpack the parent under ``build/``,
copy this module into its ``tools/`` and run both, in turns.
"""

import argparse
import collections
import dataclasses
import hashlib
import os
import statistics
import subprocess
import time
import types
import warnings
from functools import cached_property, partial
from unittest.mock import patch

import numpy as np
import torch

from .. import parallel as SP
from ..graph.csr import from_coo
from ..graph.device import resolve_device, sync, to_device
from ..io import rmat
from ..models.bc import bc_device
from ..models.bfs import bfs_device
from ..models.hits import hits_device
from ..models.pr import pagerank, pagerank_device
from ..models.sssp import sssp_device
from ..models.tc import _tc_prepare, _tc_run
from ..models.wtf import wtf_device
from ..ops import _build
from ..ops import intersection as I
from ..ops import kernels as K
from ..ops import pull2 as P
from ..ops.advance import expand
from ..parallel.blocked import blocked_from_partition

PR_ITERS, HITS_ITERS = 20, 10
WTF_ITERS = 50  # wtf_device's max_iters, which PPR reaches on R-MAT
TIMED_LAUNCHES = 20
TC_PROFILED_CHUNKS = 5
# profile_run: the sentinel kernels that open a window (torch.cuda._sleep,
# whose kernel is named so, each a few microseconds), how many at first,
# and the profiles it takes, with four times as many each time, before it
# gives up on a whole one.
SENTINEL, SENTINEL_CYCLES = "spin_kernel", 5000
LEAD, ATTEMPTS = 64, 5


# --- The timers ---------------------------------------------------------

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
        wall = (time.perf_counter() - t0) * 1e3 / runs
    per_name = collections.defaultdict(lambda: [0, 0.0])
    sentinels = aten_ops = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            aten_ops += evt.name.startswith("aten::")
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
    return {"wall_ms": wall, "device_ms": device_ms, "whole": whole,
            "aten_ops": aten_ops / runs,
            "events": sorted(((name, calls / runs, ms / runs)
                              for name, (calls, ms) in per_name.items()),
                             key=lambda r: -r[2])}


def profile_run(fn, runs: int = TIMED_LAUNCHES, device="cuda") -> dict:
    """Profile ``runs`` calls of ``fn`` after one warm-up call.

    On the H100 the profiler can lose the first device events of a
    window, more of them the older the process, while the host still
    records every launch (a ``chip_smoke.py`` run kept 7 of K8's 20). So
    each window opens with :data:`LEAD` sentinel kernels, left out of the
    result, and a profile counts only where a sentinel survived (the loss
    ended before the calls) and each kernel name came a whole number of
    times a call; otherwise it is taken again with four times the
    sentinels, up to :data:`ATTEMPTS` times, and then this raises. On the
    CPU there are no device events to lose."""
    device = torch.device(device)
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


def call_ms(fn, reps: int = TIMED_LAUNCHES, device="cuda"):
    """Median time of a call on the card's clock (a CUDA event before and
    after, the host path included where the card waits on it) over
    ``reps`` calls after a warm-up, the upper of the middle two for an
    even count; None off the card."""
    if torch.device(device).type != "cuda":
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
    return sorted(times)[len(times) // 2]


def wall_ms(fn, runs: int, device, fenced: bool) -> list:
    """The host time of each of ``runs`` calls of ``fn`` after a warm-up
    call: until the device is done (``fenced``) or until the call returns,
    the device drained before the next."""
    fn()
    sync(device)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if fenced:
            sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        sync(device)
    return times


def card_string(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    if torch.device(device).type != "cuda":
        return f"{torch.device(device).type} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


# --- What the cases need ------------------------------------------------

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


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes: equal digests, equal bits."""
    h = hashlib.sha1()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def host_reads(fn, device) -> int:
    """The synchronizing calls of one run of ``fn`` on a card."""
    if device.type != "cuda":
        return 0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def brandes_source(dg, lab, sig, fwd=P.brandes_fwd_levels,
                   bwd=P.brandes_bwd_levels, levels: int = 8):
    """One BC source as the kernel-C route runs it, from its labels and
    path counts ``lab`` and ``sig``: forward levels in calls of ``levels``
    until one labels nobody, then every backward ring, through K9 (or
    ``fwd`` and ``bwd``). Returns the labels, the path counts, the deltas
    and the counts of every call."""
    d, counts = 1, []
    while True:
        lab, sig, chg = fwd(dg, lab, sig, d0=d, levels=levels)
        counts.append(chg)
        chg = chg.tolist()
        if 0 in chg:
            depth = d + chg.index(0) - 1
            break
        d += levels
    delta = torch.zeros(dg.v_pad, device=lab.device)
    for t in range(depth - 1, -1, -levels):
        delta, ring = bwd(dg, lab, sig, delta, t0=t,
                          levels=min(levels, t + 1))
        counts.append(ring)
    return lab, sig, delta, torch.cat(counts)


def _each(fn, items, *rest):
    """A call of ``fn(item, *rest)`` for every item, as one case."""
    return lambda: [fn(item, *rest) for item in items]


def _upload(**flags):
    """A set-up's R-MAT uploaded with ``flags``, once."""
    return cached_property(
        lambda s: to_device(s.g, device=s.dev, **flags))


class Setup:
    """The graphs, uploads and inputs of the cases, each built when a
    selected case first needs it."""

    def __init__(self, args):
        self.args = args
        self.dev = resolve_device(args.device)

    @cached_property
    def g(self):
        a = self.args
        g = rmat(scale=a.scale, edge_factor=a.edge_factor, seed=1,
                 undirected=True)
        g.random_edge_values(seed=7)
        print(f"graph: rmat n{a.scale} e{a.edge_factor} seed 1, |V|="
              f"{g.num_nodes} |E|={g.num_edges}, on {card_string(self.dev)}")
        return g

    @cached_property
    def hub(self) -> int:
        return self.g.largest_degree_vertex()

    @cached_property
    def delta(self) -> float:
        return 32.0 * float(np.mean(self.g.edge_values))

    value_graph = _upload(with_csc=True, with_edge_src=True,
                          with_blocked_values=True)
    sssp_graph = _upload(with_edge_values=True, with_blocked_values=True)
    k1_graph = _upload(with_csc=True, with_blocked_csc=True)
    pull_graph = _upload(with_csc=True, with_edge_values=True)
    pr_graph = _upload(with_csc=True, with_blocked_values=True)

    @cached_property
    def grid_graph(self):
        side = self.args.grid_side
        gg = grid(side)
        gg.random_edge_values(seed=1)
        dgw = to_device(gg, with_edge_values=True, with_blocked_values=True,
                        device=self.dev)
        print(f"graph: grid {side}x{side}, |E|={dgw.num_edges}")
        return dgw

    @cached_property
    def pull(self):
        """The pull group's inputs, drawn from one generator: values a
        vertex, ``--winners`` sorted ids in a v_pad buffer with their
        values and count on the device (phase 14's K8), the SSSP start
        from the hub and 3 plain sweeps on, PageRank's start, and the
        CSC as a sparse CSR matrix and with every source vertex 0."""
        dev, hub = self.dev, self.hub
        dg = self.pull_graph
        v, e, n = dg.v_pad, dg.num_edges, dg.num_nodes
        rng = np.random.default_rng(1)

        def rand():
            return torch.from_numpy(rng.random(v, dtype=np.float32)).to(dev)

        p = types.SimpleNamespace(dg=dg, rng=rng, vals=rand())
        p.csr = torch.sparse_csr_tensor(dg.csc_offsets, dg.csc_indices[:e],
                                        torch.ones(e, device=dev),
                                        size=(v, v))
        p.one_source = dataclasses.replace(
            dg, csc_indices=torch.zeros_like(dg.csc_indices))
        ids = np.sort(rng.choice(v, min(self.args.winners, v),
                                 replace=False)).astype(np.int32)
        p.winners = ids.shape[0]
        p.buf = torch.from_numpy(np.pad(ids, (0, v - p.winners))).to(dev)
        p.wins, p.dense = rand(), rand()
        p.count = torch.tensor(p.winners, dtype=torch.int32, device=dev)
        p.ids_k, p.wins_k = p.buf[:p.winners].long(), p.wins[:p.winners]
        at_hub = torch.arange(v, device=dev) == hub
        p.seed = torch.where(at_hub, 0.0, float("inf"))
        p.mid, _ = P.pull_min_sweeps_plain(dg, p.seed, sweeps=3)
        p.sig = at_hub.float()
        p.rank0 = torch.where(torch.arange(v, device=dev) < n, 1.0 / n, 0.0)
        p.reset = 0.15 / n
        return p

    @cached_property
    def push(self):
        """K5's and K7's inputs at phase 14's push round, and BC's ring sum
        by source over its frontier with the hub added."""
        dg, dev, hub = self.pull.dg, self.dev, self.hub
        rng = np.random.default_rng(1)
        deg = (dg.row_offsets[1:] - dg.row_offsets[:-1]).long()
        perm = torch.from_numpy(rng.permutation(dg.num_nodes)).to(dev)
        take = torch.cumsum(deg[perm], 0) <= dg.num_edges // 16
        frontier = torch.sort(perm[take]).values.to(torch.int32)
        ex = expand(dg, frontier, with_dst=False)
        # SSSP distances from the hub by K6 sweeps to their fixpoint.
        dist, chg = P.pull_min_sweeps(dg, self.pull.seed, sweeps=6)
        while int(chg[-1]):
            dist, chg = P.pull_min_sweeps(dg, dist, sweeps=6)
        half = torch.where(torch.from_numpy(rng.random(dg.v_pad) < 0.5)
                           .to(dev), float("inf"), dist)
        dst, w = K.sample_sorted2(dg.col_indices, dg.edge_values, ex.eid)
        sd, order = torch.sort(dst, stable=True)
        with_hub = torch.unique(torch.cat([frontier, torch.tensor(
            [hub], dtype=torch.int32, device=dev)]))
        exh = expand(dg, with_hub, with_dst=False)
        add = torch.from_numpy(rng.random(exh.total, dtype=np.float32)
                               ).to(dev)
        return types.SimpleNamespace(
            ex=ex, half=half, sd=sd,
            cand=(K.sample_sorted(half, ex.src) + w)[order],
            aux=half[sd.long()], out_min=min(dg.e_pad, dg.v_pad),
            src=exh.src, add=add, out_sum=min(exh.total, dg.v_pad) + 128)

    @cached_property
    def fronts(self):
        """DO-BFS's pull levels from the hub (where none pulls, the
        largest frontier's) and their packed frontiers."""
        records = []
        labels, _, _ = bfs_device(self.pull.dg, self.hub,
                                  direction_optimized=True,
                                  instrument=records)
        depths = [r["iteration"] - 1 for r in records
                  if r["phase"] == "pull"]
        if not depths:
            sizes = torch.bincount(labels[labels >= 0].long())
            depths = [int(torch.argmax(sizes))]
        return types.SimpleNamespace(
            depths=depths, words=[K.pack_bitmask(labels == d)
                                  for d in depths])

    @cached_property
    def k2(self):
        """K2's mask (half set), the hub's neighbours as the push slices
        them from ``col_indices``, 2^22 random ids, and a fill larger than
        the H100's 50 MB L2, which leaves the ids cold, as on the path."""
        p, dev = self.pull, self.dev
        dg = p.dg
        words = K.pack_bitmask(torch.from_numpy(p.rng.random(dg.v_pad) < 0.5)
                               .to(dev))
        start, end = dg.row_offsets[self.hub:self.hub + 2].tolist()
        nbr = dg.col_indices[start:end]
        ids = torch.from_numpy(p.rng.integers(0, dg.v_pad, 1 << 22)
                               .astype(np.int32)).to(dev)
        return types.SimpleNamespace(
            words=words, nbr=nbr, ids=ids, at=nbr.data_ptr() % 16,
            flush=torch.empty(1 << 24, dtype=torch.float32, device=dev))

    @cached_property
    def shards(self):
        a = self.args
        mesh = SP.make_mesh(a.shards, device=self.dev)
        pg, perm = SP.partition(self.g, a.shards, method="random",
                                with_csc=True, with_ghosts=True,
                                with_edge_values=True, device=mesh.device)
        print(f"shards: {a.shards} stacked on {mesh.device}, src {self.hub}")
        return types.SimpleNamespace(
            mesh=mesh, pg=pg, src=int(perm[self.hub]),
            glob=blocked_from_partition(pg),
            min_add=blocked_from_partition(pg, compact=True,
                                           edge_weight="csc"))

    @cached_property
    def tc(self):
        return _tc_prepare(self.g)


# --- The cases ----------------------------------------------------------

# ``run(setup)`` builds what the case needs, measures it and prints.
Case = collections.namedtuple("Case", "name group run")


def _value(name: str, iters: int, make) -> Case:
    def run(s):
        r = profile_run(make(s), s.args.runs, s.dev)
        print_profile(name, f"{iters} iterations, {s.args.runs} profiled "
                      f"runs", r)
    return Case(name, "value", run)


def _sssp(name: str, make) -> Case:
    def run(s):
        fn = make(s)
        runs = 1 if "grid" in name else s.args.runs  # the grid: host-bound
        best = min(wall_ms(fn, runs, s.dev, fenced=True))
        print_profile(name, f"best {best:.3f} ms of {runs}; {runs} profiled "
                      f"runs", profile_run(fn, runs, s.dev), top=12)
    return Case(name, "sssp", run)


def _pull(name: str, make) -> Case:
    """A kernel case: ``make(s.pull, s)`` gives the call."""
    def run(s):
        fn, reps = make(s.pull, s), s.args.reps
        host = statistics.median(wall_ms(fn, reps, s.dev, fenced=False))
        call = call_ms(fn, reps, s.dev)
        call = "not measured" if call is None else f"{call:.4f} ms"
        r = profile_run(fn, reps, s.dev)
        print_profile("profile_pull", f"{name.format(s=s)} (host "
                      f"{host:.4f} ms a call, call {call})", r)
        if name.startswith("K1") and r["device_ms"] > 0:
            print("[profile_pull]   a launch: " + "; ".join(
                f"{ev[:40]} {ms / calls:.4f} ms" for ev, calls, ms in
                r["events"]))
        if name.startswith("K4") and r["device_ms"] > 0:
            split = power_split(r, 20)
            print(f"[profile_pull]   K4 split: tile rows {split['build']:.4f}"
                  f" ms a call; pass 1 {split['pass1']:.4f} ms a round; the "
                  f"rest {split['rest']:.4f} ms a round")
    return Case(name, "pull", run)


def _k8_host_path(s) -> None:
    """K8's host path in three cuts: the wrapper, its launch helper with
    the arguments ready, and the C entry point alone (on the card)."""
    if s.dev.type != "cuda":
        return
    p = s.pull
    dev = p.dg.device  # with its index, which ``_launch`` needs
    lib = _build.load()
    kargs = (p.dense.data_ptr(), p.dense.shape[0], p.buf.data_ptr(),
             p.wins.data_ptr(), p.buf.shape[0], p.count.data_ptr(), 0, 1, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, fn in (
            ("K8 wrapper", lambda: K.scatter_sorted(
                p.dense, p.buf, p.wins, count=p.count, op="min")),
            ("K8 _launch", lambda: K._launch(lib.gr_scatter_sorted, *kargs,
                                             device=dev)),
            ("K8 C entry point", lambda: lib.gr_scatter_sorted(*kargs,
                                                               stream))):
        host = statistics.median(wall_ms(fn, s.args.reps, dev, fenced=False))
        print(f"[profile_pull] host path, {name}: {host:.4f} ms")


def _sharded(name: str, make, read) -> Case:
    def run(s):
        fn = make(s)
        steps, dig = read(fn())
        times = wall_ms(fn, s.args.reps, s.dev, fenced=True)
        reads = host_reads(fn, s.dev)
        r = profile_run(fn, 1, s.dev)
        kernels = sum(calls for _, calls, _ in r["events"])
        one = (f"{kernels:.0f} kernels busy {r['device_ms']:.3f} ms"
               if r["device_ms"] > 0 else "device not measured")
        print(f"{name}: median {statistics.median(times):.3f} ms, least "
              f"{min(times):.3f}, most {max(times):.3f} over {len(times)} "
              f"runs; supersteps {steps}, host reads {reads} "
              f"({reads / max(steps, 1):.2f} a superstep), digest {dig}; "
              f"one run: {r['aten_ops']:.0f} ATen operators, {one}")
    return Case(name, "sharded", run)


def _tc_steps(s) -> None:
    """TC's device time in its first chunks, step by step, and the wall,
    device time and busy share of a whole run (the upload and the chunk
    loop)."""
    prep, dev = s.tc, s.dev
    drow, dcol, desrc = (torch.from_numpy(a).to(dev)
                         for a in (prep.row, prep.col, prep.esrc_full))
    n = prep.dag.num_edges
    chunks = list(zip(prep.bounds, prep.bounds[1:TC_PROFILED_CHUNKS + 1]))
    steps = dict.fromkeys(("expansion", "sort", "run flag and gather",
                           "scatters"), 0.0)
    for a, b in chunks:
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
    total = sum(steps.values())
    split = ", ".join(f"{k} {v:.3f} ms ({100.0 * v / total:.1f}%)"
                      for k, v in steps.items()) if total > 0 else \
        "device not measured"
    print(f"[tc] the first {len(chunks)} of {len(prep.bounds) - 1} chunks "
          f"by step: {split}")
    print_profile("tc", "a whole run", profile_run(
        lambda: _tc_run(prep, dev), 1, dev), top=6)


# One row a case, in the order they run. A pull case's name may hold
# ``{s.<field>}`` fields, filled in from the set-up once it is built.
CASES = (
    _value("pagerank power route", PR_ITERS,
           lambda s: partial(pagerank_device, s.value_graph,
                             max_iters=PR_ITERS, threshold=0.0)),
    _value("pagerank loop route", PR_ITERS,
           lambda s: partial(pagerank_device, s.value_graph,
                             max_iters=PR_ITERS, threshold=0.0,
                             instrument=[])),
    _value("hits", HITS_ITERS,
           lambda s: partial(hits_device, s.value_graph, HITS_ITERS)),
    _value("wtf", WTF_ITERS,
           lambda s: partial(wtf_device, s.value_graph, s.hub)),

    _sssp("sssp sweep route",
          lambda s: partial(sssp_device, s.sssp_graph, s.hub)),
    _sssp("sssp near-far",
          lambda s: partial(sssp_device, s.sssp_graph, s.hub,
                            mode="nearfar", delta=s.delta)),
    _sssp("sssp near-far fused",
          lambda s: partial(sssp_device, s.sssp_graph, s.hub,
                            mode="nearfar", delta=s.delta, fused=True)),
    _sssp("sssp grid",
          lambda s: partial(sssp_device, s.grid_graph, 0, mode="pull",
                            delta=256.0)),
    _sssp("sssp grid, deep_carry",
          lambda s: partial(sssp_device, s.grid_graph, 0, mode="pull",
                            delta=256.0, deep_carry=True)),
    _sssp("non-DO bfs grid", lambda s: partial(bfs_device, s.grid_graph, 0)),
    _sssp("DO-bfs, K10",
          lambda s: partial(bfs_device, s.sssp_graph, s.hub,
                            direction_optimized=True)),
    _sssp("DO-bfs, K1",
          lambda s: partial(bfs_device, s.k1_graph, s.hub,
                            direction_optimized=True)),
    _sssp("DO-bfs grid",
          lambda s: partial(bfs_device, s.grid_graph, 0,
                            direction_optimized=True)),
    _sssp("bc hybrid",
          lambda s: with_env(partial(bc_device, s.sssp_graph, s.hub),
                             GUNROCK_BC_PULL2="0")),
    _sssp("bc hybrid fused",
          lambda s: with_env(partial(bc_device, s.sssp_graph, s.hub,
                                     fused=True), GUNROCK_BC_PULL2="0")),

    _pull("K3 pull_reduce2 sum/none",
          lambda p, s: partial(P.pull_reduce2, p.vals, p.dg)),
    _pull("torch.mv (sparse CSR)",
          lambda p, s: partial(torch.mv, p.csr, p.vals)),
    _pull("K3 sum/none, every source vertex 0",
          lambda p, s: partial(P.pull_reduce2, p.vals, p.one_source)),
    _pull("K8 scatter_sorted min, {s.pull.winners} winners of "
          "{s.pull.dg.v_pad}",
          lambda p, s: partial(K.scatter_sorted, p.dense, p.buf, p.wins,
                               count=p.count, op="min")),
    _pull("index_reduce_ amin, the same winners",
          lambda p, s: partial(p.dense.index_reduce_, 0, p.ids_k, p.wins_k,
                               "amin")),
    _pull("K4 pull_power_iters, 20 rounds",
          lambda p, s: partial(P.pull_power_iters, p.dg, p.rank0, iters=20,
                               damping=0.85, reset=p.reset)),
    _pull("K4 pull_power_iters, 20 rounds at threshold 1e-6",
          lambda p, s: partial(P.pull_power_iters, p.dg, p.rank0, iters=20,
                               damping=0.85, reset=p.reset, threshold=1e-6)),
    _pull("PageRank power route, pagerank's defaults",
          lambda p, s: partial(pagerank, s.pr_graph)),
    _pull("K6 pull_min_sweeps, 6 sweeps add/val from the hub",
          lambda p, s: partial(P.pull_min_sweeps, p.dg, p.seed, sweeps=6)),
    _pull("K6 pull_min_sweeps, the first sweep from the hub",
          lambda p, s: partial(P.pull_min_sweeps, p.dg, p.seed, sweeps=1)),
    _pull("K6 pull_min_sweeps, 3 sweeps after 3 plain ones",
          lambda p, s: partial(P.pull_min_sweeps, p.dg, p.mid, sweeps=3)),
    _pull("K9 brandes_levels, one source from the hub",
          lambda p, s: partial(brandes_source, p.dg, p.seed, p.sig)),
    _pull("K5 sample_sorted2 + sample_sorted, a push round's payload, "
          "{s.push.ex.total} lanes",
          lambda p, s: lambda r=s.push: (
              K.sample_sorted2(p.dg.col_indices, p.dg.edge_values, r.ex.eid),
              K.sample_sorted(r.half, r.ex.src))),
    _pull("K7 reduce_by_dst_sorted min with aux, {s.push.sd.shape[0]} lanes",
          lambda p, s: partial(K.reduce_by_dst_sorted, s.push.sd,
                               s.push.cand, op="min", aux=s.push.aux,
                               out_lanes=s.push.out_min)),
    _pull("K7 reduce_by_dst_sorted sum by source with the hub, "
          "{s.push.src.shape[0]} lanes",
          lambda p, s: partial(K.reduce_by_dst_sorted, s.push.src,
                               s.push.add, op="sum",
                               out_lanes=s.push.out_sum)),
    _pull("K1 pull_reached_words, pull levels {s.fronts.depths}",
          lambda p, s: _each(K.pull_reached_words, s.fronts.words, p.dg)),
    _pull("K1 pull_reached_words, every source vertex 0, pull levels "
          "{s.fronts.depths}",
          lambda p, s: _each(K.pull_reached_words, s.fronts.words,
                             p.one_source)),
    _pull("K10 bitmask_gather_cumsum, pull levels {s.fronts.depths}, "
          "{s.pull.dg.csc_indices.shape[0]} ids",
          lambda p, s: _each(K.bitmask_gather_cumsum, s.fronts.words,
                             p.dg.csc_indices)),
    _pull("K10L1 bitmask_gather_cumsum, the mask through L1, pull levels "
          "{s.fronts.depths}",
          lambda p, s: _each(K._gather_cumsum, s.fronts.words,
                             p.dg.csc_indices, False)),
    _pull("K2 bitmask_gather, the hub's {s.k2.nbr.shape[0]} neighbours "
          "(offset {s.k2.at} bytes mod 16)",
          lambda p, s: partial(K.bitmask_gather, s.k2.words, s.k2.nbr)),
    _pull("K2 bitmask_gather, the hub's neighbours, L2 flushed before each "
          "call (the fill's events apart)",
          lambda p, s: lambda k=s.k2: (k.flush.zero_(),
                                       K.bitmask_gather(k.words, k.nbr))),
    _pull("K2 bitmask_gather, {s.k2.ids.shape[0]} random ids",
          lambda p, s: partial(K.bitmask_gather, s.k2.words, s.k2.ids)),
    Case("K8 host path: the wrapper, _launch, the C entry point", "pull",
         _k8_host_path),

    _sharded("DO-BFS (K1)",
             lambda s: partial(SP.bfs_sharded_device, s.shards.pg,
                               s.shards.src, mesh=s.shards.mesh,
                               mark_preds=True, direction_optimized=True,
                               blocked=s.shards.glob),
             lambda r: (r[2], digest(r[0], r[1]))),
    _sharded("non-DO BFS",
             lambda s: partial(SP.bfs_sharded_device, s.shards.pg,
                               s.shards.src, mesh=s.shards.mesh,
                               mark_preds=True),
             lambda r: (r[2], digest(r[0], r[1]))),
    _sharded("SSSP near-far (K3)",
             lambda s: partial(SP.sssp_sharded_device, s.shards.pg,
                               s.shards.src, mesh=s.shards.mesh,
                               mode="nearfar", delta=s.delta,
                               blocked=s.shards.min_add),
             lambda r: (r[1], digest(r[0]))),

    Case("tc steps and busy share", "tc", _tc_steps),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=20)
    p.add_argument("--edge-factor", type=int, default=32)
    p.add_argument("--grid-side", type=int, default=1024)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--reps", type=int, default=TIMED_LAUNCHES)
    p.add_argument("--winners", type=int, default=135_241)
    p.add_argument("--device", default="cuda")
    p.add_argument("--only", nargs="*", default=None)
    args = p.parse_args(argv)
    setup = Setup(args)
    for case in CASES:
        if args.only and not any(word in f"{case.group} {case.name}"
                                 for word in args.only):
            continue
        case.run(setup)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
