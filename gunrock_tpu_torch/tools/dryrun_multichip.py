"""Dry run of the whole sharded pipeline on a shard mesh of one device.

The counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: every sharded primitive once, on tiny shapes —
sharded DO-BFS with predecessors (plain pulls, then K1 a shard through
the shard views, labels equal), SSSP bellman and near-far with the K3
pull-relax (distances equal), PageRank plain and through K3 (ranks
within 1e-5), CC, BC, the replicated BFS batch, HITS, WTF, SALSA, TopK
and TC. The JAX package builds an n-device mesh; the port puts the n
shards on one device (``parallel/mesh.py``).

    python -m gunrock_tpu_torch.tools.dryrun_multichip 8
    python -m gunrock_tpu_torch.tools.dryrun_multichip 8 --device=cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def dryrun_multichip(n_shards: int, device="cuda") -> str:
    """Run the pipeline on ``n_shards`` shards of ``device``; returns
    (and prints) its summary line. Raises on any mismatch."""
    from .. import io
    from ..parallel import (bc_sharded_device, bfs_batch, bfs_sharded_device,
                            cc_sharded_device, hits_sharded, make_mesh,
                            pagerank_sharded_device, partition,
                            salsa_sharded, sssp_sharded_device, tc_sharded,
                            topk_sharded, wtf_sharded)
    from ..parallel.blocked import blocked_from_partition

    mesh = make_mesh(n_shards, device=device)
    dev = mesh.device
    g = io.rmat(scale=9, edge_factor=8, seed=7, undirected=True,
                random_edge_values=True)

    # Sharded direction-optimized BFS, plain pulls, then K1 a shard.
    pg, perm = partition(g, n_shards, method="random", seed=1, with_csc=True,
                         device=dev)
    labels, _, iters, _, ovf, comm_bytes, trace = bfs_sharded_device(
        pg, int(perm[0]), mesh=mesh, mark_preds=True,
        direction_optimized=True)
    assert iters > 0 and not ovf and int(labels.max()) > 0
    pulls = int((trace[:iters] == 1).sum())
    blabels, _, _, _, bovf, _, _ = bfs_sharded_device(
        pg, int(perm[0]), mesh=mesh, direction_optimized=True,
        blocked=blocked_from_partition(pg))
    assert not bovf and torch.equal(blabels, labels), \
        "the K1 route of sharded BFS diverged from the plain route"

    # Sharded SSSP: the push route, then near-far with the K3 pull-relax.
    pgw, permw = partition(g, n_shards, method="biasrandom", seed=1,
                           with_edge_values=True, device=dev)
    dist, siters, sovf, _ = sssp_sharded_device(pgw, int(permw[0]),
                                                mesh=mesh)
    assert siters > 0 and not sovf
    pgw2, permw2 = partition(g, n_shards, method="random", seed=1,
                             with_edge_values=True, with_csc=True,
                             with_ghosts=True, device=dev)
    ndist, niters, novf, _ = sssp_sharded_device(
        pgw2, int(permw2[0]), mesh=mesh, mode="nearfar", delta=0.5,
        blocked=blocked_from_partition(pgw2, compact=True,
                                       edge_weight="csc"), pull_frac=16)
    assert niters > 0 and not novf
    assert np.array_equal(ndist.cpu().numpy()[permw2],
                          dist.cpu().numpy()[permw]), \
        "near-far with the K3 pull-relax diverged from bellman"

    # Sharded PageRank (plain, then K3 a shard), CC and BC.
    pg2, perm2 = partition(g, n_shards, method="static", with_csc=True,
                           with_ghosts=True, device=dev)
    v_pad = pg2.v_global_pad
    out_deg = np.zeros(v_pad, np.float32)
    out_deg[perm2] = np.diff(g.row_offsets).astype(np.float32)
    vmask = np.zeros(v_pad, bool)
    vmask[perm2] = True
    out_deg_t = torch.from_numpy(out_deg).to(dev)
    vmask_t = torch.from_numpy(vmask).to(dev)
    rank, priters = pagerank_sharded_device(
        pg2, mesh=mesh, out_degrees_new=out_deg_t, vmask_new=vmask_t,
        max_iters=5)
    assert priters > 0
    inv_deg = torch.where(out_deg_t > 0, 1.0 / out_deg_t.clamp(min=1.0), 0.0)
    brank, _ = pagerank_sharded_device(
        pg2, mesh=mesh, out_degrees_new=out_deg_t, vmask_new=vmask_t,
        max_iters=5, blocked=blocked_from_partition(
            pg2, compact=True, edge_weight=lambda sg, dl, i: inv_deg[sg]))
    assert float((brank - rank).abs().max()) < 1e-5
    _, citers = cc_sharded_device(pg2, mesh=mesh, vmask_new=vmask_t)
    assert citers > 0
    _, _, _, bdepth = bc_sharded_device(pg2, int(perm2[0]), mesh=mesh)
    assert bdepth > 0

    # Replicated execution, link analysis, WTF, TopK, TC.
    batch = bfs_batch(g, [0, 1, 2, 3], mesh=mesh)
    assert batch.labels.shape[0] == 4
    hres = hits_sharded(g, mesh=mesh, max_iters=3)
    assert np.isfinite(hres.hubs).all() and hres.hubs.max() > 0
    wres = wtf_sharded(g, src=0, mesh=mesh, max_iters=3)
    assert wres.node_ids.shape[0] > 0 and np.isfinite(wres.scores).all()
    sres = salsa_sharded(g, mesh=mesh, max_iters=3)
    assert np.isfinite(sres.hubs).all() and sres.hubs.max() > 0
    tkres = topk_sharded(g, k=8, mesh=mesh)
    assert tkres.node_ids.shape[0] == 8
    tcres = tc_sharded(g, mesh=mesh)
    assert tcres.total >= 0

    line = (f"dryrun_multichip({n_shards}) on {dev}: bfs iters={iters} "
            f"(pull={pulls}, comm={float(comm_bytes):.0f}B), sssp "
            f"iters={siters}, pr iters={priters}, cc iters={citers}, bc "
            f"depth={bdepth}, batch_bfs 4 srcs, hits, salsa, wtf, topk "
            f"k=8, tc={tcres.total} — all ten sharded primitives OK")
    print(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shards", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.shards, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
