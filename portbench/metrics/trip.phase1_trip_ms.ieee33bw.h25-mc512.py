"""Milliseconds a phase-1 Newton trip in the IEEE 33-bus feeder's cell,
where the blocks are 130 wide and the capacitance system 832:
``trip.phase1_trip_ms``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("trip.phase1_trip_ms")(rec)
