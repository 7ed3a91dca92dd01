"""Share of the traced window's call time in the device-side schedule's
gathered rescue and cold restart (``PhaseLog`` phases "rescue_phase2"
and "cold_restart")."""


def read(rec):
    ph = rec["phases"]
    if ph is None or "cold_restart" not in ph["seconds"]:
        return None
    s = ph["seconds"]
    return (s.get("rescue_phase2", 0.0) + s["cold_restart"]) \
        / sum(rec["calls"])
