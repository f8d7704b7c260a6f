"""Run a set of runs of one cell, one process after another, and print
each metric's median and spread.

    python3 gbench/tools/sets.py --workload <name> --seeds 11 12 ...
        [--seconds 10] [--trace 0] [--out build/gbench/sets]

Each run is ``gbench/run.py`` in a process of its own, as the check
runs it; its standard output and error are kept under ``--out`` (one
``<workload>.<seed>.<trace>.{out,err}`` pair a run) with one
``runs.jsonl`` line a run (seed, exit code, wall, result). The spread is
the distance between the quartiles as a share of the median
(``gbench.stats.spread``), the one the bounds are set from. This tool
never touches the device itself.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[0] = ROOT

from gbench.stats import spread  # noqa: E402


def run_one(workload: str, seed: int, seconds: float, trace: int,
            out: str, timeout: float) -> dict:
    base = os.path.join(out, f"{workload}.{seed}.{trace}")
    cmd = [sys.executable, os.path.join("gbench", "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t = time.perf_counter()
    with open(base + ".out", "w") as fo, open(base + ".err", "w") as fe:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, stdout=fo, stderr=fe,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    wall = time.perf_counter() - t
    result, aside = None, None
    with open(base + ".out") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if rc == 0 and lines:
        result = json.loads(lines[-1])
        if len(lines) > 1 and lines[-2].startswith('{"aside"'):
            aside = json.loads(lines[-2])["aside"]
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": wall, "result": result, "aside": aside}


def summary(runs: list) -> list[str]:
    """One line a metric: its median, spread, and every value."""
    values: dict = {}
    for r in runs:
        if r["result"]:
            for k, m in r["result"]["metrics"].items():
                values.setdefault(k, []).append(m["value"])
    lines = []
    for k, vals in values.items():
        sp = spread(vals) if len(vals) >= 2 else float("nan")
        lines.append(f"{k}: median {statistics.median(vals)!r} spread "
                     f"{sp!r} values {vals!r}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=os.path.join("build", "gbench", "sets"))
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for seed in args.seeds:
        r = run_one(args.workload, seed, args.seconds, args.trace, args.out,
                    args.timeout)
        runs.append(r)
        with open(os.path.join(args.out, "runs.jsonl"), "a") as f:
            f.write(json.dumps(r) + "\n")
        res = r["result"] or {}
        print(f"[sets] {args.workload} seed {seed} trace {args.trace}: rc "
              f"{r['rc']} wall {r['wall_s']:.1f} s correct "
              f"{res.get('correct')} "
              f"{json.dumps({k: v['value'] for k, v in res.get('metrics', {}).items()})}",
              flush=True)
    for line in summary(runs):
        print(f"[sets] {args.workload} {line}", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                    for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
