"""Statistics the benchmark reports and the spread its bounds rest on."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile of all ``values`` (Python's
    ``statistics.quantiles`` with ``n=100``, ``method="inclusive"``):
    every sample counts, none is dropped."""
    vals = list(values)
    if len(vals) == 1:
        return float(vals[0])
    return statistics.quantiles(vals, n=100, method="inclusive")[pct - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``), the spread the
    benchmark's bounds are set from."""
    q1, med, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / med
