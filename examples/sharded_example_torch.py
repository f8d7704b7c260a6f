"""Multi-shard demo of the PyTorch port: the sharded zoo on a shard
mesh of one device.

Partitions one graph into shards on one device (``--device``, the card
by default; the port keeps every shard there, the reference's
``--device=0,0`` trick), then runs sharded BFS / PageRank / CC and
checks each against its single-card result. The twin of
``examples/sharded_example.py``.

Run:

  python examples/sharded_example_torch.py              # on the card
  python examples/sharded_example_torch.py --device=cpu --shards=8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gunrock_tpu_torch as gtt  # noqa: E402
from gunrock_tpu_torch.parallel import (bfs_sharded, cc_sharded,  # noqa: E402
                                        make_mesh, pagerank_sharded)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)
    mesh = make_mesh(args.shards, device=args.device)
    g = gtt.io.rmat(scale=12, edge_factor=16, seed=0, undirected=True)
    src = int(g.largest_degree_vertex())
    print(f"graph: |V|={g.num_nodes} |E|={g.num_edges}; "
          f"mesh: {mesh.num_shards} shards on {mesh.device}")

    # Sharded direction-optimized BFS: every shard's advance, owner
    # routing, boundary merge; pulls through K1 a shard on the card.
    rb = bfs_sharded(g, src=src, mesh=mesh, direction_optimized=True)
    single = gtt.bfs(g, src=src, direction_optimized=True,
                     device=args.device)
    assert (rb.labels == single.labels).all(), "sharded BFS diverged"
    print(f"bfs:  depth={rb.labels.max()}  "
          f"comm={rb.info['comm_bytes'] / 1024:.1f} KiB  "
          f"[matches single-card]")

    # Sharded PageRank: a pull SpMV a shard (K3 on the card), a ghost
    # exchange a round.
    rp = pagerank_sharded(g, mesh=mesh, max_iters=30)
    sp = gtt.pagerank(g, max_iters=30, device=args.device)
    top_match = set(map(int, rp.node_ids[:10])) == \
        set(map(int, sp.node_ids[:10]))
    print(f"pr:   top vertex={int(rp.node_ids[0])}  "
          f"[top-10 {'matches' if top_match else 'DIFFERS from'} "
          f"single-card]")

    # Sharded connected components: hooks, local jumps and periodic
    # global collapse rungs.
    rc = cc_sharded(g, mesh=mesh)
    sc = gtt.cc(g, device=args.device)
    assert rc.num_components == sc.num_components, "sharded CC diverged"
    print(f"cc:   {rc.num_components} components  [matches single-card]")


if __name__ == "__main__":
    main()
