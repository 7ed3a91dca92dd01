"""1 - the device's busy time (union of its kernel, copy and fill records)
over the wall time of the device segment's calls, traced on the device
only."""


def read(rec):
    d = rec["device"]
    if d is None or not d["wall_us"]:
        return None
    return 1.0 - d["busy_us"] / d["wall_us"]
