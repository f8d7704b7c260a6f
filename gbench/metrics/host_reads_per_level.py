"""host_reads_per_level: the blocking device-to-host reads the program's
host loops make a level (a ``.tolist()``, an ``int()`` of a device
value, a ``nonzero`` size, a boolean-mask index or assignment), from its
own process-wide counts (``COUNTS``: "host_reads" over "levels").
Nothing to read off the card or where the program keeps no such counts.

A known error: the harness's ``Query`` keeps no ``info``, so this is not
the window's ratio. It takes in the warm-up call's and the traced
calls' roots too (a root's reads repeat, so only the mix of roots
differs); ``PERF.md`` section 3 gives the measured size of the bias."""

from gbench.program_spans import COUNTS, program


def read(run):
    counts = program(COUNTS)
    if run.device.type != "cuda" or not counts or not counts.get("levels"):
        return None
    return counts["host_reads"] / counts["levels"]
