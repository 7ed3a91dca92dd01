"""Newton trips a call in the IEEE 33-bus feeder's cell, every phase
counted: ``lanes.trips_per_sweep``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("lanes.trips_per_sweep")(rec)
