"""The control of a cell: the plain reference put in the program's place
with one guarantee broken, judged as a run judges the program.

    python3 gbench/tools/control.py --workload <name> --seeds 11 12 13
        [--variants no_tree one_level_short]

For each seed: the cell's graph and roots as a run makes them, then as
many answers as a run compares at most (``check.answers`` a root for
the traffic's ``check.roots`` roots, and the longest query's), each from
the control ``variant`` of the reference (``Reference.control``) over
the roots in the window's order, judged by the reference.
``--variants`` defaults to the reference module's ``CONTROLS``. Prints
one JSON line a seed and variant with each count, the reference's
readings, and whether a run would call it correct. A control must come
out not correct on every seed. Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from gbench import harness

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    wl = bench.workload(args.workload)
    cfg = bench.config(wl["config"])
    tr = bench.traffic(wl["traffic"])
    gen = bench.plugin("graphs", cfg["generator"])
    refmod = bench.plugin("reference", tr["reference"])
    undirected = bool(cfg.get("undirected", False))
    check = tr["check"]
    all_failed = True
    for seed in args.seeds:
        graph = harness.make_graph(gen, cfg, seed, device)
        roots = harness.draw_roots(refmod, cfg, tr, graph, undirected, seed,
                                   device)
        ref = harness.reference(refmod, cfg, graph, undirected, device)
        del graph
        answers = min(int(check.get("roots", 1)), len(roots)) * int(
            check.get("answers", 1)) + 1
        for variant in args.variants or refmod.CONTROLS:
            order = [roots[i % len(roots)] for i in range(answers)]
            counts, readings = harness.judge(
                refmod, ref, ((r, ref.control(r, variant)) for r in order))
            correct = all(counts[k] <= lim
                          for k, lim in refmod.LIMITS.items())
            all_failed &= not correct
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "compared": answers,
                              "counts": counts, "readings": readings,
                              "correct": correct}),
                  flush=True)
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
