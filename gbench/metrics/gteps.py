"""gteps: traversed edges per second over the window, in billions.

Every edge of every query completed in the window (each query's work by
the traffic's rule, counted by the reference, never read from the
program), over the window's whole time, first call to last return."""


def read(run):
    if not run.queries or run.window_s <= 0:
        return None
    return sum(q.work for q in run.queries) / run.window_s / 1e9
