"""host_syncs_per_query: CUDA runtime calls after which the host has
waited for the device (``trace.HOST_SYNCS``: stream, device and event
synchronizes and synchronous copies; PyTorch's device-to-host copies end
in a stream synchronize), counted in the traced stretch from the
profiler's CPU events, per whole query profiled."""

from gbench.trace import HOST_SYNCS


def read(run):
    t = run.trace
    if t is None or run.device.type != "cuda" or not t.device:
        return None
    return sum(t.runtime[name] for name in HOST_SYNCS) / t.queries
