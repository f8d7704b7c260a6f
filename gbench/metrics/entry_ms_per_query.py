"""entry_ms_per_query: what the public call costs around the work it
times itself: the mean over the window's queries of the call's wall time
less the program's own span of the traversal (``info["process_ms"]``).
It holds the copies of the answer to the host, the host-side counts and
the run record."""


def read(run):
    if not run.queries:
        return None
    return sum(q.wall_s * 1e3 - q.span_ms
               for q in run.queries) / len(run.queries)
