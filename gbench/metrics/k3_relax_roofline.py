"""k3_relax_roofline: kernel K3's share of its roofline in SSSP's pull
rounds, in percent.

K3 (``ops.pull2.pull_reduce2``, min with ``add``: the tile-rows prologue
``csc_tile_rows_kernel``, pass 1 ``pull_tiles_kernel`` and pass 2
``pull_finish_kernel``) runs once a pull round, a round whose frontier's
edges pass E/16. The least time of the traced stretch's K3 launches is
their bytes (``roofline.pull_bytes`` a launch with two edge streams,
``csc_indices`` and ``csc_edge_values``, and three 4-byte entries a row,
the offsets, the gathered table and the output, over the graph as the
reference counts it) over the published 3.35 TB/s; the share is that
over their device time in the trace. Counted by pass 2, which each
launch runs once. Nothing to read where no pull round ran."""

from gbench.metrics.k3_roofline import KERNELS, PASS2
from gbench.roofline import bound, pull_bytes


def read(run):
    t = run.trace
    if t is None:
        return None
    launches = t.device_count(lambda n: PASS2 in n)
    if launches == 0:
        return None
    device_ms = t.device_us(lambda n: any(k in n for k in KERNELS)) / 1e3
    g = run.graph
    need = bound(launches * pull_bytes(g["num_edges"], g["num_nodes"], 3,
                                       edge_streams=2))
    return 100.0 * need["bound_ms"] / device_ms
