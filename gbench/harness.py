"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, the metrics and the result.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its generator ``graphs/<generator>.py``, its traffic
file ``traffic/<traffic>.json`` (see ``traffic.py``), the reference
``reference/<reference>.py`` and each metric's reader
``metrics/<metric>.py``, whose ``read(run)`` takes a :class:`Run` and
returns a number, or None where it finds nothing to read (the metric is
then left out of the line).

The program is reached only through the dotted names of the traffic
file, which must lie in :data:`PROGRAM`:

- ``build``: ``call(num_nodes, src, dst, undirected=..., **kwargs)``, the
  host graph from the COO, with ``values=`` where the configuration
  draws edge values (``edge_values``, see :func:`make_graph`);
- ``upload``: ``call(host_graph, device=..., **kwargs)``, the graph on
  the device;
- ``entry``: ``call(device_graph, **{root_kwarg: root}, **kwargs)``, one
  query, or ``call(device_graph, **kwargs)`` where ``root_kwarg`` is
  null: a whole-graph entry, whose traffic's one root is None (every
  query is then the same call); ``answer`` names the attributes
  of its result that are judged (host arrays, as the public calls return
  them), and ``span`` the key of ``result.info`` that holds the
  program's own span of the work.

The reference is built from the same COO, with ``values=`` where the
configuration draws edge values and the configuration's ``algorithm``
object as keyword arguments where it has one (the parameters its
guarantee states). Its module's ``LIMITS`` are counts summed over the
answers compared, each printed beside its limit; any other number its
``judge`` gives is a reading, printed in the aside line as its largest
over the answers. ``CONTROLS`` names its control variants
(``tools/control.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import trace as tracing
from . import traffic as traffic_mod

PKG = "gbench"
PROGRAM = "gunrock_tpu_torch"
# Top-level module names that no run may load: jax and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "gunrock_tpu")
# After this many failed queries the window stops.
MAX_FAILED = 5


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    loaded modules), each compared whole: ``gunrock_tpu_torch`` is not
    ``gunrock_tpu``."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None
                                         else names)}
    return sorted(tops.intersection(FORBIDDEN))


def resolve(dotted: str):
    """The program's object at ``dotted``, which must lie in
    :data:`PROGRAM`."""
    mod_name, attr = dotted.rsplit(".", 1)
    if mod_name.split(".", 1)[0] != PROGRAM:
        raise ValueError(f"{dotted!r} is not in {PROGRAM}")
    return getattr(importlib.import_module(mod_name), attr)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root,
                               self._named("configs", name)["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.root, PKG, "traffic",
                               f"{name}.json")) as f:
            return json.load(f)

    def plugin(self, kind: str, name: str):
        """The module ``<PKG>/<kind>/<name>.py``."""
        path = os.path.join(self.root, PKG, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"{PKG}_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, workload: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its
        per-layer ones: those that list it, or list no cells."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Query:
    root: Optional[int]  # None for a whole-graph entry
    wall_s: float        # call to return, the answer on the host
    span_ms: float       # the program's own span (result.info[span])
    work: int = 0        # by the traffic's work rule, set after judging


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    workload: dict
    config: dict
    traffic: dict
    device: torch.device
    spans: dict                   # host-clock seconds, by name
    queries: list                 # the window's queries, in order
    window_s: float               # first call to last return
    memory_peak_bytes: int
    trace: Optional[tracing.Trace]
    graph: dict                   # num_nodes, num_edges (the reference's)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, once a run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def make_graph(gen, cfg: dict, seed: int, device: torch.device) -> dict:
    """The configuration's graph from the seed (``gen.generate``), and
    where the configuration has ``edge_values``, ``values``: float32,
    one a generated COO edge, from the seed's own stream
    (``traffic.edge_values``)."""
    graph = gen.generate(cfg, seed, device)
    if "edge_values" in cfg:
        graph["values"] = traffic_mod.edge_values(
            cfg["edge_values"], graph["src"].size, seed, device)
    return graph


def reference(refmod, cfg: dict, graph: dict, undirected: bool,
              device: torch.device):
    """The plain reference over the benchmark's COO, with the edge values
    and the configuration's ``algorithm`` parameters where it has them."""
    kwargs = dict(cfg.get("algorithm", {}))
    if "values" in graph:
        kwargs["values"] = graph["values"]
    return refmod.Reference(graph["num_nodes"], graph["src"], graph["dst"],
                            undirected=undirected, device=device, **kwargs)


def draw_roots(refmod, cfg: dict, tr: dict, graph: dict, undirected: bool,
               seed: int, device: torch.device) -> list:
    """The run's roots by the traffic's rule, as ints; ``[None]`` where
    the rule is null (a whole-graph entry). Where the rule needs the
    components, the reference works them out and is freed."""
    if tr["roots"] is None:
        return [None]
    comp = None
    if "outside_largest" in tr["roots"]:
        ref = reference(refmod, cfg, graph, undirected, device)
        comp = ref.components().cpu().numpy()
        del ref
    return traffic_mod.draw_roots(tr["roots"], graph, undirected, seed,
                                  comp).tolist()


def root_kwargs(entry: dict, root: Optional[int]) -> dict:
    """The entry's keyword for ``root``: none for a whole-graph entry."""
    return {} if root is None else {entry["root_kwarg"]: root}


def sample(tr: dict, seed: int) -> traffic_mod.Sample:
    """The traffic's ``check``: which answers of the window are compared."""
    check = tr["check"]
    return traffic_mod.Sample(int(check.get("roots", 1)), seed,
                              int(check.get("answers", 1)))


def judge(refmod, ref, checked) -> tuple[dict, dict]:
    """(counts, readings) of the ``(root, answer)`` pairs ``checked`` (an
    iterable, read once): each of the reference module's ``LIMITS``
    summed over the answers, and the largest of each other number its
    ``judge`` gives."""
    counts, readings = dict.fromkeys(refmod.LIMITS, 0), {}
    for root, answer in checked:
        for k, v in ref.judge(root, answer).items():
            if k in counts:
                counts[k] += v
            else:
                readings[k] = max(readings.get(k, v), v)
    return counts, readings


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_process: float,
             log=sys.stderr) -> tuple[dict, dict]:
    """One run of cell ``name``; returns (result line, aside line).

    ``t_process`` is the host clock (``time.perf_counter``) at process
    start: ``setup_s`` runs from it to the end of the warm-up query,
    less the benchmark's own generator work."""
    now = time.perf_counter
    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    tr = bench.traffic(wl["traffic"])
    gen = bench.plugin("graphs", cfg["generator"])
    refmod = bench.plugin("reference", tr["reference"])
    undirected = bool(cfg.get("undirected", False))
    spans: dict = {}
    aside: dict = {}
    t = now()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    spans["cuda_init_s"] = now() - t

    # The benchmark's own graph and roots, timed apart from set-up.
    t = now()
    spans["start_s"] = t - t_process
    graph = make_graph(gen, cfg, seed, device)
    n = graph["num_nodes"]
    roots = draw_roots(refmod, cfg, tr, graph, undirected, seed, device)
    if device.type == "cuda":
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    aside["gen_s"] = now() - t
    print(f"[gbench] {name} seed {seed}: {n} vertices, {graph['src'].size} "
          f"generated edges, {len(roots)} roots, generator "
          f"{aside['gen_s']:.3f} s", file=log, flush=True)

    # The program's set-up: import, host build, upload, one warm query.
    t = now()
    build, upload = resolve(tr["build"]["call"]), resolve(tr["upload"]["call"])
    entry = resolve(tr["entry"]["call"])
    spans["import_s"] = now() - t
    t = now()
    values = {"values": graph["values"]} if "values" in graph else {}
    host = build(n, graph["src"], graph["dst"], undirected=undirected,
                 **values, **tr["build"].get("kwargs", {}))
    spans["build_s"] = now() - t
    t = now()
    dg = upload(host, device=device, **tr["upload"].get("kwargs", {}))
    _sync(device)
    spans["upload_s"] = now() - t
    del host
    ent = tr["entry"]
    kwargs = dict(ent.get("kwargs", {}))
    answer_keys, span_key = ent["answer"], ent["span"]

    def call(root: Optional[int]):
        t0 = now()
        res = entry(dg, **root_kwargs(ent, root), **kwargs)
        answer = {k: getattr(res, k) for k in answer_keys}
        wall = now() - t0
        return Query(root=root, wall_s=wall,
                     span_ms=float(res.info[span_key])), answer

    t = now()
    call(roots[0])
    spans["warmup_s"] = now() - t
    spans["setup_s"] = now() - t_process - aside["gen_s"]
    print(f"[gbench] set-up {spans['setup_s']:.3f} s (start "
          f"{spans['start_s']:.3f} with CUDA {spans['cuda_init_s']:.3f}, "
          f"import {spans['import_s']:.3f}, build {spans['build_s']:.3f}, upload "
          f"{spans['upload_s']:.3f}, warm-up {spans['warmup_s']:.3f})",
          file=log, flush=True)

    # The window: a closed loop of one caller through the roots.
    checks_due = sample(tr, seed)
    queries: list = []
    errors: list = []
    sent = [0]

    def next_query() -> Optional[Query]:
        root = roots[sent[0] % len(roots)]
        sent[0] += 1
        try:
            q, answer = call(root)
        except Exception as e:  # a failed query is counted, not fatal
            errors.append(f"root {root}: {type(e).__name__}: {e}")
            return None
        checks_due.offer(q.wall_s, q.root, (q.root, answer))
        return q

    t0 = now()
    t_end = t0
    while now() - t0 < seconds and len(errors) < MAX_FAILED:
        q = next_query()
        t_end = now()
        if q is not None:
            queries.append(q)
    window_s = t_end - t0

    trace = None
    if traced and len(errors) < MAX_FAILED:
        tq = tr.get("trace", {})
        trace = tracing.profile_queries(
            next_query, int(tq.get("queries", 4)), device,
            tq.get("spans", ()), int(tq.get("label_queries", 1)))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    # The program's state goes before the reference runs on the device.
    del dg, entry, call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = now()
    ref = reference(refmod, cfg, graph, undirected, device)
    works = dict(zip(roots, ref.work(tr["work"], roots)))
    for q in queries:
        q.work = works[q.root]
    aside["reference_s"] = now() - t
    t = now()
    checked = checks_due.items()
    counts, readings = judge(refmod, ref, checked)
    aside["judge_s"] = now() - t
    compared = len(checked)
    graph_info = {"num_nodes": n, "num_edges": ref.num_edges}
    del ref, checks_due, checked
    gc.collect()

    run = Run(workload=wl, config=cfg, traffic=tr, device=device,
              spans=spans, queries=queries, window_s=window_s,
              memory_peak_bytes=peak, trace=trace, graph=graph_info)
    metrics = {}
    for m in bench.metrics(name, traced):
        value = bench.plugin("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    failed = len(errors)
    checks = {"failed": {"value": failed, "limit": 0}}
    for k, limit in refmod.LIMITS.items():
        checks[k] = {"value": counts[k], "limit": limit}
    checks["compared"] = {"value": compared, "min": 1}
    correct = failed == 0 and compared >= 1 and all(
        counts[k] <= limit for k, limit in refmod.LIMITS.items())
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": sent[0],
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace is not None and device.type == "cuda":
        dev_info["busy_s"] = trace.busy_us / 1e6
        dev_info["window_s"] = trace.window_us / 1e6
        result["breakdown"] = {"device_ops": trace.top_device_ops(),
                               "idle_gaps": trace.idle_by_host}
    result["checks"] = checks
    aside.update(queries=len(queries), window_s=window_s,
                 traced_queries=trace.queries if trace else 0,
                 traced_launches=trace.program_launches() if trace else {},
                 num_edges=graph_info["num_edges"], errors=errors[:5],
                 readings=readings,
                 **_spread_of_queries(queries))
    return result, aside


def _spread_of_queries(queries: list) -> dict:
    """Quartiles of the window's query walls, program spans and work,
    for the aside line."""
    out = {}
    for key, vals in (("wall_ms", [q.wall_s * 1e3 for q in queries]),
                      ("span_ms", [q.span_ms for q in queries]),
                      ("work", [q.work for q in queries])):
        if vals:
            out[key] = [float(np.percentile(vals, p))
                        for p in (0, 25, 50, 75, 100)]
    out["walls_ms"] = [round(q.wall_s * 1e3, 1) for q in queries]
    return out
