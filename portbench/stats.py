"""The arithmetic of a measured window: rates over the whole window, the
tail of all its jobs, and the spread of repeated runs."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(count: float, seconds: float) -> float:
    """Work per second over the window: every unit done in it over all of
    its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it (a value that was measured)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def beyond(values: Sequence[float], q: float) -> int:
    """How many values lie above the q-th percentile."""
    p = percentile(values, q)
    return sum(v > p for v in values)


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
