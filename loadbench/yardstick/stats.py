"""Percentiles, rates and spreads over every request of a window."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile ``q`` (0-100) over all ``values``; a missing
    value is ``math.inf`` and ranks above every finite one. None for no
    values, inf when the rank falls on a missing value."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(math.ceil(q / 100.0 * len(ordered)), 1)
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """All of ``count`` over all of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, with ``statistics.quantiles(values, n=4)``'s quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
