"""pred_fill_device_ms_per_query: the device time of the kernels that
the program's pred fill launched (those whose launch on the host lies
inside an ``<entry>.fill_preds`` span), per traced query, in ms. Read
from a device-only stretch taken under the program's ``tracing()``
(``program_spans.profile_spans``); nothing to read from a trace without
the program's spans."""

from gbench.program_spans import device_ms_launched_in, entry_prefix


def read(run):
    t = run.trace
    if t is None or not getattr(t, "spans", None) or not t.device:
        return None
    return device_ms_launched_in(t, f"{entry_prefix(run)}.fill_preds")
