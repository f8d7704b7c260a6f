"""The control of a cell: the plain reference put in the program's place
with one guarantee broken, judged as a run judges the program.

    python3 gbench/tools/control.py --workload <name> --seeds 11 12 13
        [--variants no_tree one_level_short]

For each seed: the cell's graph and roots as a run makes them, then as
many answers as a run compares at most (one a root for the traffic's
``check.roots`` roots, and the longest query's), each from the control
``variant`` of the reference (``Reference.control``) over the roots in
the window's order, judged by the reference. Prints one JSON line a seed and variant with each count
and whether a run would call it correct. A control must come out not
correct on every seed. Needs the card, as a run does.
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
    p.add_argument("--variants", nargs="+",
                   default=["no_tree", "one_level_short"])
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
    answers = min(int(tr["check"]["roots"]), int(tr["roots"]["count"])) + 1
    all_failed = True
    for seed in args.seeds:
        graph = gen.generate(cfg, seed, device)
        roots = harness.draw_roots(refmod, tr, graph, undirected, seed,
                                   device)
        ref = refmod.Reference(graph["num_nodes"], graph["src"],
                               graph["dst"], undirected=undirected,
                               device=device)
        del graph
        for variant in args.variants:
            counts = {k: 0 for k in refmod.LIMITS}
            for i in range(answers):
                root = int(roots[i % len(roots)])
                for k, v in ref.judge(root, ref.control(root,
                                                        variant)).items():
                    counts[k] += v
            correct = all(counts[k] <= lim
                          for k, lim in refmod.LIMITS.items())
            all_failed &= not correct
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "compared": answers,
                              "counts": counts, "correct": correct}),
                  flush=True)
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
