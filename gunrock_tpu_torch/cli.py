"""Command-line entry point, the counterpart of :mod:`gunrock_tpu.cli`.

Usage mirrors the JAX package's CLI (and the reference's
``tests/<primitive>/test_<primitive>.cu``)::

    python -m gunrock_tpu_torch bfs rmat --rmat_scale=20 \
        --rmat_edgefactor=32 --rmat_seed=1 --undirected \
        --direction-optimized --src=largestdegree --mark-pred
    python -m gunrock_tpu_torch sssp rmat --rmat_scale=16 \
        --src=largestdegree --mark-pred --mode=nearfar
    python -m gunrock_tpu_torch pr rmat --rmat_scale=20 --max-iter=20
    python -m gunrock_tpu_torch hits rmat --rmat_scale=16 --max-iter=10
    python -m gunrock_tpu_torch bc rmat --rmat_scale=16 --src=largestdegree
    python -m gunrock_tpu_torch cc rmat --rmat_scale=16
    python -m gunrock_tpu_torch wtf rmat --rmat_scale=16 --src=largestdegree
    python -m gunrock_tpu_torch topk rmat --rmat_scale=16 --top-nodes=10
    python -m gunrock_tpu_torch tc rmat --rmat_scale=16 --undirected

Each run: load/generate the graph -> run the primitive
``--iteration-num`` times on ``--device`` (default ``cuda``) -> validate
against the in-package numpy oracle with the JAX CLI's tolerances
(skipped by ``--quick``) -> print CORRECT/INCORRECT -> write the Info
JSON run record to ``--jsonfile/--jsondir``. Ported so far: ``bfs``,
``sssp``, ``pr``/``pagerank``, ``hits``, ``salsa``, ``bc``, ``cc``,
``wtf``, ``topk`` and ``tc`` (checked against ``cpu_tc``), each also
sharded: ``--num-shards=N`` (0, the default, runs the single-card
path) routes every primitive through its sharded path in
``gunrock_tpu_torch.parallel`` on ``N`` shards of ``--device``, with
``--partition-method`` and ``--partition-seed``, as the JAX CLI routes
them (its multi-chip flags; the reference's ``--device=0,0`` trick).
``--random-edge-values`` gives a market graph weights
seeded by ``--edge-value-seed`` and an R-MAT graph weights seeded by
``--rmat_seed``, as the JAX CLI's loader does; ``sssp`` gives a graph
still without edge values ``random_edge_values(seed=--edge-value-seed)``
and runs on the host graph, as the JAX CLI does. On CUDA, ``pr`` uploads the
graph ``with_blocked_values``, so that it takes the power route (kernel
K4) where the JAX package's rule allows; the host graph, which the JAX
CLI passes, would take the loop route (kernel K3). In the same way, on CUDA, ``bc``
uploads the graph ``with_blocked_values`` (the kernel-C route, K9, on an
undirected graph) and ``cc`` a symmetric graph ``with_edge_src`` and
``with_blocked_values``, as ``bench_all.py`` uploads them.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .graph.csr import CsrGraph
from .io import generators, market
from .utils import reference as oracle
from .utils.info import write_info

__all__ = ["main", "build_parser", "load_graph_from_args"]

PRIMITIVES = ("bfs", "sssp", "pr", "pagerank", "hits", "salsa", "bc",
              "cc", "wtf", "topk", "tc")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gunrock_tpu_torch",
        description="Graph analytics on PyTorch and CUDA (Gunrock-parity CLI)")
    p.add_argument("primitive", choices=PRIMITIVES)
    p.add_argument("graph_type", nargs="?", default="rmat",
                   choices=("market", "rmat", "rgg", "smallworld", "binary"),
                   help="graph source (reference graph_type argv)")
    p.add_argument("graph_file", nargs="?", default=None,
                   help="path for market/binary graph types")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu for the plain "
                        "PyTorch path)")

    g = p.add_argument_group("graph")
    g.add_argument("--undirected", action="store_true",
                   help="symmetrize edges (reference --undirected)")
    g.add_argument("--random-edge-values", action="store_true",
                   help="attach uniform random weights (market reader flag)")
    g.add_argument("--rmat_scale", type=int, default=10)
    g.add_argument("--rmat_edgefactor", type=float, default=16.0)
    g.add_argument("--rmat_a", type=float, default=0.57)
    g.add_argument("--rmat_b", type=float, default=0.19)
    g.add_argument("--rmat_c", type=float, default=0.19)
    g.add_argument("--rmat_seed", type=int, default=0)
    g.add_argument("--rgg_nodes", type=int, default=1 << 10)
    g.add_argument("--rgg_threshold", type=float, default=None)
    g.add_argument("--sw_nodes", type=int, default=1 << 10)
    g.add_argument("--sw_k", type=int, default=6)
    g.add_argument("--sw_p", type=float, default=0.1)
    g.add_argument("--no-cache", action="store_true",
                   help="skip the binary .csr cache when loading market")
    g.add_argument("--edge-value-seed", type=int, default=0,
                   help="seed of the random edge values of a market graph "
                        "and of those SSSP gives a graph without them")

    r = p.add_argument_group("run")
    r.add_argument("--src", default="0",
                   help="source vertex: int | largestdegree | randomize "
                        "(reference --src)")
    r.add_argument("--iteration-num", type=int, default=1,
                   help="number of timed runs (reference --iteration-num)")
    r.add_argument("--quick", action="store_true",
                   help="skip CPU reference validation (reference --quick)")
    r.add_argument("--instrumented", action="store_true",
                   help="collect per-iteration records (reference "
                        "--instrumented)")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--queue-sizing", type=float, default=1.0,
                   help="queue capacity factor (reference --queue-sizing): "
                        "SSSP and BC queues; for BFS, the capacity that "
                        "decides which deep micro-loop rungs exist")
    r.add_argument("--jsonfile", default=None)
    r.add_argument("--jsondir", default=None)
    r.add_argument("--seed", type=int, default=0)

    m = p.add_argument_group("multi-chip")
    m.add_argument("--num-shards", type=int, default=0,
                   help="shard across N shards of --device (reference "
                        "--device list; 0 = single card)")
    m.add_argument("--partition-method", default="random",
                   choices=("random", "biasrandom", "cluster", "static",
                            "metis", "duplicate"))
    m.add_argument("--partition-seed", type=int, default=0)

    a = p.add_argument_group("primitive options")
    a.add_argument("--mark-pred", action="store_true",
                   help="BFS MARK_PREDECESSORS / SSSP MARK_PATHS")
    a.add_argument("--idempotence", action="store_true",
                   help="accepted for parity (the claim filter is exact)")
    a.add_argument("--direction-optimized", action="store_true")
    a.add_argument("--do_a", type=float, default=15.0,
                   help="DO-BFS push->pull factor (reference do_a=0.001)")
    a.add_argument("--do_b", type=float, default=18.0,
                   help="DO-BFS pull->push factor (reference do_b=0.200)")
    a.add_argument("--traversal-mode", default="LB",
                   help="accepted for parity; the advance is always "
                        "load-balanced by edges (LB/TWC/LB_CULL/...)")
    a.add_argument("--mode", default="bellman", choices=("bellman", "nearfar"),
                   help="SSSP strategy (near-far delta-stepping pile)")
    a.add_argument("--delta-factor", type=float, default=32.0,
                   help="SSSP near-far delta factor (reference gunrock.h:98)")
    a.add_argument("--max-iter", type=int, default=50,
                   help="PR/HITS/SALSA/WTF iteration cap (reference "
                        "--max-iter)")
    a.add_argument("--error", type=float, default=1e-6,
                   help="PR convergence threshold (reference --error)")
    a.add_argument("--normalized", action="store_true", default=True)
    a.add_argument("--top-nodes", type=int, default=10,
                   help="TopK / WTF result count")
    a.add_argument("--alpha", type=float, default=0.2,
                   help="WTF teleport parameter")
    return p


def load_graph_from_args(args) -> CsrGraph:
    if args.graph_type == "market":
        if not args.graph_file:
            raise SystemExit("market graph type needs a .mtx path")
        return market.load_market(args.graph_file,
                                  undirected=args.undirected or None,
                                  random_edge_values=args.random_edge_values,
                                  seed=args.edge_value_seed,
                                  use_cache=not args.no_cache)
    if args.graph_type == "binary":
        if not args.graph_file:
            raise SystemExit("binary graph type needs a .csr.npz path")
        return CsrGraph.read_binary(args.graph_file)
    if args.graph_type == "rmat":
        # R-MAT graphs are always symmetrized, as in the JAX package's CLI.
        return generators.rmat(
            scale=args.rmat_scale, edge_factor=args.rmat_edgefactor,
            a=args.rmat_a, b=args.rmat_b, c=args.rmat_c,
            seed=args.rmat_seed, undirected=True,
            random_edge_values=args.random_edge_values)
    if args.graph_type == "rgg":
        return generators.rgg(args.rgg_nodes, args.rgg_threshold,
                              seed=args.seed)
    if args.graph_type == "smallworld":
        return generators.small_world(args.sw_nodes, args.sw_k, args.sw_p,
                                      seed=args.seed)
    raise SystemExit(f"unknown graph type {args.graph_type}")


def _resolve_src(args, g: CsrGraph, rng) -> int:
    if args.src == "largestdegree":
        return g.largest_degree_vertex()
    if args.src == "randomize":
        return int(rng.integers(0, g.num_nodes))
    return int(args.src)


def _report(ok: bool, label: str, quiet: bool) -> bool:
    if not quiet:
        print(f"{label} validation: {'CORRECT' if ok else 'INCORRECT'}")
    return ok


def _shards(args) -> dict:
    """The sharded entry points' partition and device arguments."""
    return dict(num_shards=args.num_shards,
                partition_method=args.partition_method,
                seed=args.partition_seed, device=args.device)


def _run_bfs(args, g, src):
    if args.num_shards:
        from .parallel.bfs import bfs_sharded
        res = bfs_sharded(g, src, mark_preds=args.mark_pred, **_shards(args))
    else:
        from .models.bfs import bfs
        res = bfs(g, src, mark_preds=args.mark_pred,
                  direction_optimized=args.direction_optimized,
                  alpha=args.do_a, beta=args.do_b,
                  queue_sizing=args.queue_sizing,
                  idempotence=args.idempotence,
                  instrumented=args.instrumented, device=args.device)
    ok = True
    if not args.quick:
        ok = _report(bool(np.array_equal(res.labels, oracle.cpu_bfs(g, src))),
                     "bfs", args.quiet)
    return res.info, ok


def _run_sssp(args, g, src):
    if g.edge_values is None:
        g.random_edge_values(seed=args.edge_value_seed)
    if args.num_shards:
        from .parallel.sssp import sssp_sharded
        res = sssp_sharded(g, src, mode=args.mode,
                           delta_factor=args.delta_factor, **_shards(args))
    else:
        from .models.sssp import sssp
        res = sssp(g, src, mark_preds=args.mark_pred, mode=args.mode,
                   delta_factor=args.delta_factor,
                   queue_sizing=args.queue_sizing,
                   instrumented=args.instrumented, device=args.device)
    ok = True
    if not args.quick:
        ref = oracle.cpu_sssp(g, src)
        ok = _report(bool(np.allclose(res.distances, ref, rtol=1e-4,
                                      atol=1e-4)), "sssp", args.quiet)
    return res.info, ok


def _run_pr(args, g, src):
    from .graph.device import resolve_device, to_device
    from .models.pr import pagerank
    if args.num_shards:
        from .parallel.pr import pagerank_sharded
        res = pagerank_sharded(g, damping=0.85, max_iters=args.max_iter,
                               **_shards(args))
    else:
        graph = g
        if resolve_device(args.device).type == "cuda":
            graph = to_device(g, with_csc=True, with_blocked_values=True,
                              device=args.device)
        res = pagerank(graph, damping=0.85, threshold=args.error,
                       max_iters=args.max_iter, normalized=args.normalized,
                       instrumented=args.instrumented, device=args.device)
    ok = True
    if not args.quick:
        ref = oracle.cpu_pagerank(g, 0.85, args.max_iter, args.error,
                                  normalized=args.normalized)
        ok = _report(bool(np.allclose(res.ranks, ref, rtol=2e-2, atol=1e-5)),
                     "pr", args.quiet)
    return res.info, ok


def _run_hits(args, g, src):
    if args.num_shards:
        from .parallel.hits import hits_sharded
        res = hits_sharded(g, max_iters=args.max_iter, **_shards(args))
    else:
        from .models.hits import hits
        res = hits(g, max_iters=args.max_iter, device=args.device)
    ok = True
    if not args.quick:
        hub, auth = oracle.cpu_hits(g, args.max_iter)
        ok = _report(bool(np.allclose(res.hubs, hub, rtol=1e-3, atol=1e-4)
                          and np.allclose(res.auths, auth, rtol=1e-3,
                                          atol=1e-4)), "hits", args.quiet)
    return res.info, ok


def _run_salsa(args, g, src):
    if args.num_shards:
        from .parallel.hits import salsa_sharded
        res = salsa_sharded(g, max_iters=args.max_iter, **_shards(args))
    else:
        from .models.salsa import salsa
        res = salsa(g, max_iters=args.max_iter, device=args.device)
    ok = True
    if not args.quick:
        hub, auth = oracle.cpu_salsa(g, args.max_iter)
        ok = _report(bool(np.allclose(res.hubs, hub, rtol=1e-3, atol=1e-5)
                          and np.allclose(res.auths, auth, rtol=1e-3,
                                          atol=1e-5)), "salsa", args.quiet)
    return res.info, ok


def _run_bc(args, g, src):
    from .graph.device import resolve_device, to_device
    from .models.bc import bc
    if args.num_shards:
        from .parallel.bc import bc_sharded
        res = bc_sharded(g, src, **_shards(args))
    else:
        graph = g
        if resolve_device(args.device).type == "cuda":
            graph = to_device(g, with_blocked_values=True,
                              device=args.device)
        res = bc(graph, src, queue_sizing=args.queue_sizing,
                 instrumented=args.instrumented, device=args.device)
    ok = True
    if not args.quick:
        ref = oracle.cpu_bc(g, src)
        ok = _report(bool(np.allclose(res.bc_values, ref, rtol=1e-3,
                                      atol=1e-3)), "bc", args.quiet)
    return res.info, ok


def _run_cc(args, g, src):
    from .graph.device import resolve_device, to_device
    from .models.cc import _is_symmetric, cc
    if args.num_shards:
        from .parallel.cc import cc_sharded
        res = cc_sharded(g, **_shards(args))
    else:
        graph = g
        if resolve_device(args.device).type == "cuda" and _is_symmetric(g):
            graph = to_device(g, with_edge_src=True,
                              with_blocked_values=True, device=args.device)
        res = cc(graph, instrumented=args.instrumented, device=args.device)
    ok = True
    if not args.quick:
        # Component ids are representatives: compare partitions.
        same = (res.components[g.edge_sources()] ==
                res.components[g.col_indices]).all()
        n_ref = len(np.unique(oracle.cpu_cc(g)))
        ok = _report(bool(same and res.num_components == n_ref), "cc",
                     args.quiet)
    return res.info, ok


def _run_wtf(args, g, src):
    if args.num_shards:
        from .parallel.wtf import wtf_sharded
        res = wtf_sharded(g, src, alpha=args.alpha, max_iters=args.max_iter,
                          **_shards(args))
    else:
        from .models.wtf import wtf
        res = wtf(g, src, alpha=args.alpha, max_iters=args.max_iter,
                  device=args.device)
    ok = True
    if not args.quick:
        ref, ppr = oracle.cpu_wtf(g, src, alpha=args.alpha,
                                  max_iters=args.max_iter)
        # The top-k score values (the order among ties may differ) and
        # the phase-1 PPR vector.
        k = res.scores.shape[0]
        ref_top = np.sort(ref)[::-1][:k]
        ok = _report(bool(
            np.allclose(res.ppr_ranks, ppr, rtol=1e-3, atol=1e-6)
            and np.allclose(np.sort(res.scores)[::-1], ref_top,
                            rtol=1e-3, atol=1e-6)), "wtf", args.quiet)
    return res.info, ok


def _run_topk(args, g, src):
    if args.num_shards:
        from .parallel.topk import topk_sharded
        res = topk_sharded(g, k=args.top_nodes, **_shards(args))
    else:
        from .models.topk import topk
        res = topk(g, k=args.top_nodes, device=args.device)
    ok = True
    if not args.quick:
        cent = g.out_degrees + g.csc().out_degrees
        ref = np.sort(cent)[::-1][:args.top_nodes]
        ok = _report(bool(np.array_equal(np.sort(res.centralities)[::-1],
                                         ref)), "topk", args.quiet)
    return res.info, ok


def _run_tc(args, g, src):
    if args.num_shards:
        from .parallel.tc import tc_sharded
        res = tc_sharded(g, num_shards=args.num_shards, device=args.device)
    else:
        from .models.tc import tc
        res = tc(g, device=args.device)
    ok = True
    if not args.quick:
        ok = _report(res.total == oracle.cpu_tc(g), "tc", args.quiet)
    return res.info, ok


_RUNNERS = {"bfs": _run_bfs, "sssp": _run_sssp, "pr": _run_pr,
            "pagerank": _run_pr,
            "hits": _run_hits, "salsa": _run_salsa, "bc": _run_bc,
            "cc": _run_cc, "wtf": _run_wtf, "topk": _run_topk,
            "tc": _run_tc}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rng = np.random.default_rng(args.seed)
    g = load_graph_from_args(args)
    if not args.quiet:
        print(f"graph: |V|={g.num_nodes} |E|={g.num_edges} "
              f"({args.graph_type})")

    all_ok, info = True, {}
    for it in range(max(1, args.iteration_num)):
        src = _resolve_src(args, g, rng)
        info, ok = _RUNNERS[args.primitive](args, g, src)
        all_ok &= ok
        if not args.quiet:
            mteps = info.get("m_teps")
            print(f"run {it}: process {info.get('process_ms', 0.0):.3f} ms"
                  + (f", {mteps:.1f} MTEPS" if mteps else "")
                  + (f", depth {info['search_depth']}"
                     if "search_depth" in info else "")
                  + f" on {info['gpuinfo']['name']}")
            if args.instrumented and info.get("phase_ms"):
                split = ", ".join(
                    f"{k} {v:.1f} ms/{info['phase_iterations'][k]} it"
                    for k, v in sorted(info["phase_ms"].items()))
                duty = info.get("avg_duty")
                print(f"  phases: {split}"
                      + (f"; avg_duty {duty:.2f}" if duty else ""))

    path = write_info(info, args.jsonfile, args.jsondir)
    if path and not args.quiet:
        print(f"json: {path}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
