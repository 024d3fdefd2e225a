"""Percentiles and spreads over every sample: no bucketing, no medians of
chunks."""

from __future__ import annotations

import math
import statistics


def percentile(values, p: float) -> float | None:
    """The nearest-rank ``p``-th percentile: the smallest sample that at
    least p % of the samples do not exceed. None without samples."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(p / 100 * len(v)) - 1)]


def spread(values) -> float:
    """The distance between the first and third quartile
    (``statistics.quantiles(n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
