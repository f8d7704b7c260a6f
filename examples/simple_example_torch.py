"""Composition demo on the PyTorch port: CC, then BFS, then BC on one
graph.

Twin of ``examples/simple_example.py`` (the reference's
``simple_example/simple_example.cu``): find the connected components,
run direction-optimized BFS from the largest-degree vertex of the
largest component, then single-source BC from the same vertex, sharing
one loaded graph across the primitives, on the GPU.

Run:  python examples/simple_example_torch.py [path/to/graph.mtx] [--device cpu]

Without a path it generates R-MAT scale 12, edge factor 16.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import gunrock_tpu_torch as gtt  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="simple_example_torch")
    p.add_argument("path", nargs="?")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.path and os.path.exists(args.path):
        g = gtt.io.load_market(args.path, undirected=True, use_cache=False)
    else:
        if args.path:
            print(f"{args.path} not found; generating R-MAT")
        g = gtt.io.rmat(scale=12, edge_factor=16, seed=0, undirected=True)
    print(f"graph: |V|={g.num_nodes} |E|={g.num_edges}")

    # 1. connected components
    cc = gtt.cc(g, device=args.device)
    print(f"cc: {cc.num_components} components "
          f"({cc.info['process_ms']:.1f} ms)")
    comp_sizes = np.bincount(cc.components)
    biggest = int(np.argmax(comp_sizes))
    print(f"   largest component: {comp_sizes[biggest]} vertices")

    # 2. BFS from the largest-degree vertex inside the largest component
    deg = g.out_degrees.copy()
    deg[cc.components != biggest] = -1
    src = int(np.argmax(deg))
    bfs = gtt.bfs(g, src, mark_preds=True, direction_optimized=True,
                  device=args.device)
    print(f"bfs: src={src} depth={bfs.info['search_depth']} "
          f"reached={(bfs.labels >= 0).sum()} "
          f"({bfs.info['process_ms']:.1f} ms, "
          f"{bfs.info.get('m_teps', 0):.1f} MTEPS)")

    # 3. betweenness centrality from the same source
    bc = gtt.bc(g, src, device=args.device)
    top = np.argsort(-bc.bc_values)[:5]
    print(f"bc: top-5 central vertices {top.tolist()} "
          f"({bc.info['process_ms']:.1f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
