"""record_ms_per_query: the entry's host work after the copy (the
degree sum and the run record), the mean of the program's own timed
split ``<entry>.record`` (a query's ``info["record_ms"]``) over every
call of the run. Nothing to read off the card or where the program times
no such split.

A known error: the harness's ``Query`` keeps no ``info``, so this is not
the window's mean. It takes in the warm-up call and every traced call,
the last of which run with the host's operators and the benchmark's
function wrappers profiled, which slow the host; ``PERF.md`` section 3
gives the measured size of the bias against the window's mean."""

from gbench.program_spans import entry_prefix, split_mean_ms


def read(run):
    if run.device.type != "cuda":
        return None
    return split_mean_ms(f"{entry_prefix(run)}.record")
