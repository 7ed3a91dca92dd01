"""The 90th percentile of the wall time of every call in the window of
the one-card net1 cell at H<=25, where the window holds about a hundred
calls or fewer and the tail is no end-to-end metric."""
from harness import stats


def read(rec):
    return stats.p90(rec["calls"])
