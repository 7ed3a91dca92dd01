"""Newton trips a call in the one-card net2 cell at 65536 scenarios a call,
every phase counted: ``lanes.trips_per_sweep``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("lanes.trips_per_sweep")(rec)
