"""Order statistics the metrics use."""

from __future__ import annotations

import math


def percentile(values, p: float) -> float:
    """The p-th percentile by linear interpolation between closest ranks
    (numpy's default): position (n - 1) * p / 100 of the sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
