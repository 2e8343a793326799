"""Statistics of a window's readings."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q% of all values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def mean(values) -> float:
    if not values:
        raise ValueError("no values")
    return sum(values) / len(values)
