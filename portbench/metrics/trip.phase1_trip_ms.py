"""Milliseconds a Newton trip of phase 1 (the full-width trips: mismatch,
arrow step and its solves), ``PhaseLog`` "phase1" seconds over its
trips."""


def read(rec):
    ph = rec["phases"]
    if ph is None or not ph["trips"].get("phase1"):
        return None
    return 1e3 * ph["seconds"]["phase1"] / ph["trips"]["phase1"]
