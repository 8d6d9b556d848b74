"""Percentiles over every request of a window.

A tail is taken over every request submitted in the window, never over
chunks: a request that failed or never gave a first chunk is a request all
the same, counted at the longest wait it could have been given (the end of
the grace period after the window), so a missing request can only raise
the tail.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], pct: float) -> float:
    """The pct-th percentile by nearest rank: the smallest value with at
    least pct% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    k = max(1, math.ceil(pct / 100.0 * len(v)))
    return v[k - 1]


def request_latencies(submits: Sequence[float],
                      firsts: Sequence[Optional[float]],
                      give_up: float) -> list:
    """Seconds from submit to first chunk for every request; a request with
    no first chunk (None) waited until give_up."""
    return [(give_up if f is None else f) - s
            for s, f in zip(submits, firsts)]
