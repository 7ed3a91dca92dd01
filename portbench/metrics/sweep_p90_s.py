"""The 90th percentile of the wall time of every call in the window."""
from harness import stats


def read(rec):
    return stats.p90(rec["calls"])
