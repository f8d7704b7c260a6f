"""k1_roofline: kernel K1's share of its roofline, in percent.

K1 (``pull_reached_words_kernel`` and its tile-rows prologue
``csc_tile_rows_kernel``) runs once a pull level. The least time of the
traced stretch's K1 launches is their bytes (``roofline.k1_level_bytes``
a launch: the CSC's indices and offsets, the frontier's and the reach
words, over the graph as the reference counts it) over the published
3.35 TB/s; the share is that over their device time in the trace.
Nothing to read where K1 never ran."""

from gbench.roofline import bound, k1_level_bytes

K1, PROLOGUE = "pull_reached_words_kernel", "csc_tile_rows_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    launches = t.device_count(lambda n: K1 in n)
    if launches == 0:
        return None
    device_ms = t.device_us(lambda n: K1 in n or PROLOGUE in n) / 1e3
    g = run.graph
    need = bound(launches * k1_level_bytes(g["num_nodes"], g["num_edges"]))
    return 100.0 * need["bound_ms"] / device_ms
