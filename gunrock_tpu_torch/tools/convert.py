"""Graph format converters: the port's twin of the repository's
``tools/convert.py`` (the reference's ``tools/`` mtx and binary
converters and its weight add, remove and replace scripts), with the
same arguments and byte-identical outputs, built on the port's host
graph::

    python -m gunrock_tpu_torch.tools.convert mtx2bin in.mtx out.csr.npz [--undirected]
    python -m gunrock_tpu_torch.tools.convert bin2mtx in.csr.npz out.mtx
    python -m gunrock_tpu_torch.tools.convert add-weights in.csr.npz out.csr.npz --seed 1
    python -m gunrock_tpu_torch.tools.convert strip-weights in.csr.npz out.csr.npz
    python -m gunrock_tpu_torch.tools.convert info graph.{mtx,csr.npz}
"""

from __future__ import annotations

import argparse
import sys

from ..graph.csr import CsrGraph
from ..io.market import load_market

__all__ = ["main"]


def _load(path: str, undirected: bool) -> CsrGraph:
    if path.endswith(".npz"):
        return CsrGraph.read_binary(path)
    return load_market(path, undirected=undirected or None, use_cache=False)


def _write_mtx(g: CsrGraph, path: str) -> None:
    """Matrix Market, one line an edge, 1-based, as the JAX tool writes
    it (``str`` of the numpy float32 weight)."""
    with open(path, "w") as f:
        kind = "real" if g.edge_values is not None else "pattern"
        f.write(f"%%MatrixMarket matrix coordinate {kind} general\n")
        f.write(f"{g.num_nodes} {g.num_nodes} {g.num_edges}\n")
        src = g.edge_sources()
        if g.edge_values is not None:
            for s, d, w in zip(src, g.col_indices, g.edge_values):
                f.write(f"{s + 1} {d + 1} {w}\n")
        else:
            for s, d in zip(src, g.col_indices):
                f.write(f"{s + 1} {d + 1}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="convert")
    p.add_argument("cmd", choices=("mtx2bin", "bin2mtx", "add-weights",
                                   "strip-weights", "info"))
    p.add_argument("src")
    p.add_argument("dst", nargs="?")
    p.add_argument("--undirected", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lo", type=float, default=0.0)
    p.add_argument("--hi", type=float, default=64.0)
    args = p.parse_args(argv)

    g = _load(args.src, args.undirected)

    if args.cmd == "info":
        deg = g.out_degrees
        print(f"|V|={g.num_nodes} |E|={g.num_edges} "
              f"weighted={g.edge_values is not None} "
              f"undirected={g.undirected}")
        print(f"degree: min={deg.min(initial=0)} max={deg.max(initial=0)} "
              f"mean={deg.mean() if len(deg) else 0:.2f}")
        print("histogram(log2):", g.degree_histogram().tolist())
        return 0

    if not args.dst:
        p.error(f"{args.cmd} needs a destination path")

    if args.cmd == "mtx2bin":
        g.write_binary(args.dst)
    elif args.cmd == "bin2mtx":
        _write_mtx(g, args.dst)
    elif args.cmd == "add-weights":
        g.random_edge_values(args.lo, args.hi, seed=args.seed)
        g.write_binary(args.dst)
    elif args.cmd == "strip-weights":
        g.edge_values = None
        g.write_binary(args.dst)
    print(f"wrote {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
