"""The statistics of a window: rate over the whole window, tail of all
calls."""
from __future__ import annotations

import statistics


def rate(converged_total: int, window_s: float) -> float:
    """Converged scenarios of every call completed in the window over the
    time from the window's start to the last completion."""
    return converged_total / window_s


def p90(times) -> float:
    """The 90th percentile of every call's wall time (Python's
    ``statistics.quantiles``, exclusive method)."""
    if len(times) < 2:
        return float(times[0])
    return statistics.quantiles(times, n=10)[-1]
