"""loop_idle_ms_per_level: the device's idle time inside the program's
traversal span (``<entry>.process``) less that inside its pred fill
(``<entry>.fill_preds``), over its ``<entry>.level`` spans, in ms: what
the host loop leaves the device waiting a level. Read from a
device-only stretch taken under the program's ``tracing()``
(``program_spans.profile_spans``); nothing to read from a trace without
the program's spans."""

from gbench.program_spans import entry_prefix, loop_idle_ms_per_level


def read(run):
    t = run.trace
    if t is None or not getattr(t, "spans", None) or not t.device:
        return None
    return loop_idle_ms_per_level(t, entry_prefix(run))
