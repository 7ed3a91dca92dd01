"""Milliseconds a phase-1 Newton trip in the one-card net2 cell at 65536
scenarios a call, where a trip is four times the 16k cell's width:
``trip.phase1_trip_ms``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("trip.phase1_trip_ms")(rec)
