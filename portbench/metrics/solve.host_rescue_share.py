"""Share of the traced window's call time spent in the host's straggler
rescue (``solve._host_rescue``: self-warm, cold, then float64), from the
``PhaseLog`` phase "host_rescue"; 0 where no call needed it."""


def read(rec):
    ph = rec["phases"]
    if ph is None:
        return None
    return ph["seconds"].get("host_rescue", 0.0) / sum(rec["calls"])
