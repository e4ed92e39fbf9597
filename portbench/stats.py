"""Statistics of the benchmark: percentiles over all requests and the
spread of a metric over runs."""
from __future__ import annotations

import math
import statistics


def percentile(values, q):
    """The q-th percentile of all values, linear between the closest
    ranks (numpy's default): position (n - 1) * q / 100 of the sorted
    values."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values):
    """The distance between the first and third quartile
    (statistics.quantiles, n=4) as a share of the median."""
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
