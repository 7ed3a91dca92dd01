"""The device's idle share in the IEEE 33-bus feeder's cell:
``device.idle_share``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("device.idle_share")(rec)
