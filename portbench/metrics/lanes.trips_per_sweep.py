"""Newton trips a call, every phase counted (``PhaseLog.trips``), over the
traced window's calls."""


def read(rec):
    ph = rec["phases"]
    if ph is None:
        return None
    return sum(ph["trips"].values()) / len(rec["calls"])
