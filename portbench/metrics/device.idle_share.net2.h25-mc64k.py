"""The device's idle share in the one-card net2 cell at 65536 scenarios a
call: ``device.idle_share``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("device.idle_share")(rec)
