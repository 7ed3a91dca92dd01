"""The 90th percentile of the wall time of every call in the window of
the one-card net2 cell, where the window holds fewer than a hundred calls
and the tail is no end-to-end metric."""
from harness import stats


def read(rec):
    return stats.p90(rec["calls"])
