"""Share of the call time in the device schedule's gathered rescue and cold
restart in the one-card net2 cell at 65536 scenarios a call:
``lanes.restart_share``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("lanes.restart_share")(rec)
