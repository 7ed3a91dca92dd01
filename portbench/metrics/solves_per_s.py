"""Converged scenarios of every call completed in the window over the
time from the window's start to the last completion."""
from harness import stats


def read(rec):
    return stats.rate(sum(rec["converged"]), rec["window_s"])
