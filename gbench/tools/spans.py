"""Read one cell by the program's own spans and counters.

    python3 gbench/tools/spans.py --workload <name> --seed <n>
        [--queries 20] [--traced 2] [--repeats 3] [--out build/gbench/spans]

Set-up as ``gbench/run.py`` makes it (the cell's graph, roots, build,
upload and one warm-up query; a whole-graph entry's one root is None,
the same call each time), then:

- ``--queries`` queries through the roots, each with its wall and the
  ``info`` keys ``process_ms``, ``copy_ms``, ``record_ms``,
  ``host_reads`` and ``num_iterations`` (those the program gives);
- ``--repeats`` pairs of device-only stretches of ``--traced`` queries
  on the same roots (``program_spans.profile_spans``), one with the
  program's ``tracing()`` off and one with it on, in turn, the first of
  a pair alternating; each stretch's ``device_idle_pct``,
  ``host_syncs_per_query`` and ``operator_device_ms_per_query`` by the
  benchmark's readers and its wall; the traced ones also
  ``loop_idle_ms_per_level``, ``pred_fill_device_ms_per_query``,
  ``program_spans.idle_by_kind``, the host's blocking calls inside
  ``bfs.process`` against the queries' ``info["host_reads"]``, and the
  share of kernels launched inside a ``bfs`` span;
- the host cost of one span, with tracing off and on, and of one
  counted read.

Prints one JSON line and writes it to ``--out/<workload>.<seed>.json``.
A program without the spans or counts reads as None there. Needs the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[0] = ROOT

import torch  # noqa: E402

from gbench import harness, program_spans as ps  # noqa: E402

INFO_KEYS = ("process_ms", "copy_ms", "record_ms", "host_reads",
             "num_iterations")
TRACE_READERS = ("device_idle_pct", "host_syncs_per_query",
                 "operator_device_ms_per_query")
SPAN_READERS = ("loop_idle_ms_per_level", "pred_fill_device_ms_per_query")


def tracer_cost_ns(n: int = 200_000) -> dict:
    """The host's ns a span costs, entered and left, with tracing off
    and on, and a counted read; None where the program has neither."""
    enactor = sys.modules.get("gunrock_tpu_torch.enactor")
    span = getattr(enactor, "span", None)
    read = getattr(enactor, "host_read", None)
    out = {"span_off_ns": None, "span_on_ns": None, "host_read_ns": None}

    def spans() -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("bfs.level", kind="micro"):
                pass
        return (time.perf_counter_ns() - t) / n

    if span is not None:
        out["span_off_ns"] = spans()
        with enactor.tracing():
            out["span_on_ns"] = spans()
    if read is not None:
        counts = dict(enactor.COUNTS)
        t = time.perf_counter_ns()
        for _ in range(n):
            read()
        out["host_read_ns"] = (time.perf_counter_ns() - t) / n
        enactor.COUNTS.update(counts)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--queries", type=int, default=20)
    p.add_argument("--traced", type=int, default=2)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default=os.path.join("build", "gbench", "spans"))
    args = p.parse_args(argv)
    device = torch.device("cuda", 0)
    bench = harness.Bench(ROOT)
    wl = bench.workload(args.workload)
    cfg = bench.config(wl["config"])
    tr = bench.traffic(wl["traffic"])
    undirected = bool(cfg.get("undirected", False))
    graph = harness.make_graph(bench.plugin("graphs", cfg["generator"]),
                               cfg, args.seed, device)
    refmod = bench.plugin("reference", tr["reference"])
    roots = harness.draw_roots(refmod, cfg, tr, graph, undirected,
                               args.seed, device)
    entry = harness.resolve(tr["entry"]["call"])
    values = {"values": graph["values"]} if "values" in graph else {}
    host = harness.resolve(tr["build"]["call"])(
        graph["num_nodes"], graph["src"], graph["dst"],
        undirected=undirected, **values, **tr["build"].get("kwargs", {}))
    del graph
    dg = harness.resolve(tr["upload"]["call"])(
        host, device=device, **tr["upload"].get("kwargs", {}))
    del host
    ent = tr["entry"]
    kwargs = dict(ent.get("kwargs", {}))
    cursor = [0]
    infos: list = []

    def query() -> None:
        root = roots[cursor[0] % len(roots)]
        cursor[0] += 1
        t = time.perf_counter()
        res = entry(dg, **harness.root_kwargs(ent, root), **kwargs)
        wall = (time.perf_counter() - t) * 1e3
        infos.append({"root": root, "wall_ms": wall,
                      **{k: res.info[k] for k in INFO_KEYS
                         if k in res.info}})

    query()                                   # warm-up
    infos.clear()
    for _ in range(args.queries):
        query()
    window = list(infos)
    out: dict = {"workload": args.workload, "seed": args.seed,
                 "card": harness.power_limit(), "window": window}

    def mean(key):
        vals = [q[key] for q in window if key in q]
        return statistics.mean(vals) if vals else None

    levels = sum(q.get("num_iterations", 0) for q in window)
    reads = [q["host_reads"] for q in window if "host_reads" in q]
    out["window_means"] = {
        "wall_ms": mean("wall_ms"), "process_ms": mean("process_ms"),
        "copy_ms": mean("copy_ms"), "record_ms": mean("record_ms"),
        "entry_ms": statistics.mean(q["wall_ms"] - q["process_ms"]
                                    for q in window),
        "host_reads_per_level": (sum(reads) / levels
                                 if reads and levels else None)}
    start = cursor[0]
    stretches = []
    for r in range(args.repeats):
        for traced in ((False, True) if r % 2 == 0 else (True, False)):
            cursor[0] = start
            infos.clear()
            t = ps.profile_spans(query, args.traced, device, traced)
            run = harness.Run(workload=wl, config=cfg, traffic=tr,
                              device=device, spans={}, queries=[],
                              window_s=0.0, memory_peak_bytes=0, trace=t,
                              graph={})
            rec = {"traced": traced, "repeat": r, "wall_s": t.wall_s,
                   "spans": len(t.spans),
                   "host_reads": sum(q.get("host_reads", 0) for q in infos),
                   "levels": sum(q.get("num_iterations", 0)
                                 for q in infos)}
            for name in TRACE_READERS + (SPAN_READERS if traced else ()):
                rec[name] = bench.plugin("metrics", name).read(run)
            if traced and t.spans:
                rec["idle_by_level_kind"] = ps.idle_by_kind(t)
                rec["syncs_in_process"] = ps.syncs_inside(t, "bfs.process")
                rec["launched_in_bfs_share"] = ps.launched_inside_share(
                    t, "bfs")
                rec["unmatched_launches"] = sum(
                    1 for a in t.launch_us if a is None)
            stretches.append(rec)
    out["stretches"] = stretches
    out["tracer_cost"] = tracer_cost_ns()
    counts = ps.program(ps.COUNTS)
    out["counts"] = dict(counts) if counts else None
    line = json.dumps(out)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.{args.seed}.json"),
              "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
