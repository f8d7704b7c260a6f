"""k3_roofline: kernel K3's share of its roofline, in percent.

K3 (``ops.pull2.pull_reduce2``: the tile-rows prologue
``csc_tile_rows_kernel``, pass 1 ``pull_tiles_kernel`` and pass 2
``pull_finish_kernel``) runs once a PageRank iteration on the loop
route. The least time of the traced stretch's K3 launches is their bytes
(``roofline.pull_bytes`` a launch: the CSC's indices, and its offsets,
the gathered values and the output, one 4-byte entry a row each, over
the graph as the reference counts it) over the published 3.35 TB/s; the
share is that over their device time in the trace. Counted by pass 2,
which each launch runs once. Nothing to read where K3 never ran; a
trace whose ``csc_tile_rows_kernel`` also served K1 (a BFS) is not one
this reader is listed for."""

from gbench.roofline import bound, pull_bytes

PASS2, KERNELS = "pull_finish_kernel", ("csc_tile_rows_kernel",
                                        "pull_tiles_kernel",
                                        "pull_finish_kernel")


def read(run):
    t = run.trace
    if t is None:
        return None
    launches = t.device_count(lambda n: PASS2 in n)
    if launches == 0:
        return None
    device_ms = t.device_us(lambda n: any(k in n for k in KERNELS)) / 1e3
    g = run.graph
    need = bound(launches * pull_bytes(g["num_edges"], g["num_nodes"], 3))
    return 100.0 * need["bound_ms"] / device_ms
