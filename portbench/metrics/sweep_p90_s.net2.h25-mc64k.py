"""The 90th percentile of the wall time of every call in the window of the
one-card net2 cell at 65536 scenarios a call, where the tail is no end-
to-end metric."""
from harness import stats


def read(rec):
    return stats.p90(rec["calls"])
