"""query_p95_ms: the 95th percentile of the wall time of every query in
the window, call to return with the answer on the host."""

from gbench.stats import percentile


def read(run):
    if not run.queries:
        return None
    return percentile([q.wall_s * 1e3 for q in run.queries], 95)
