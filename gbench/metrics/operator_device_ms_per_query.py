"""operator_device_ms_per_query: device time of every kernel that is not
one of the program's own CUDA kernels (PyTorch's sorts, scans, index and
elementwise kernels that the operators and the host loop launch), per
whole query of the traced stretch. Copies and fills are left out."""

from gbench.trace import PROGRAM_KERNELS, is_copy_or_fill


def is_operator(name: str) -> bool:
    return not is_copy_or_fill(name) and not any(
        k in name for k in PROGRAM_KERNELS)


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return t.device_us(is_operator) / 1e3 / t.queries
