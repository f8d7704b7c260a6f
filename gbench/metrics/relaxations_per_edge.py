"""relaxations_per_edge: the edges the program's SSSP loop relaxed a
call, over the graph's directed edges (as the reference counts them):
how many times Bellman-Ford's rounds relax each edge. From the
program's own process-wide counts: ``COUNTS["edges"]``, the edges of
every round ``record_iteration`` counted (a push round's expanded edges,
a pull round's every edge), over the calls of its timed split
``<entry>.process``. Nothing to read off the card or where the program
keeps no such counts.

A known error: the harness's ``Query`` keeps no ``info``, so this is not
the window's ratio. It takes in the warm-up call's and the traced calls'
roots too (a root's rounds repeat, so only the mix of roots differs), as
``host_reads_per_level`` does; ``PERF.md`` section 3 gives the size of
that bias."""

from gbench.program_spans import COUNTS, SPLITS, entry_prefix, program


def read(run):
    counts, splits = program(COUNTS), program(SPLITS)
    if run.device.type != "cuda" or not counts or "edges" not in counts:
        return None
    calls = (splits or {}).get(f"{entry_prefix(run)}.process", (0, 0.0))[0]
    if not calls or not run.graph.get("num_edges"):
        return None
    return counts["edges"] / (calls * run.graph["num_edges"])
