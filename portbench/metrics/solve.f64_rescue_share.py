"""Share of the traced window's call time spent in the host rescue's
float64 re-solve (``solve._rescue_sweep``'s last pass), from the
``PhaseLog`` phase "rescue_float64", which the port opens inside
"host_rescue" beside "rescue_self" and "rescue_cold"; 0 where no call
re-solved in float64.  A program that counts the rescue's trips in
"host_rescue" itself has no such phase: nothing to read there."""


def read(rec):
    ph = rec["phases"]
    if ph is None or ph["trips"].get("host_rescue"):
        return None
    return ph["seconds"].get("rescue_float64", 0.0) / sum(rec["calls"])
