"""Share of the device's busy time taken by the work launched inside the
batched solves in the IEEE 33-bus feeder's cell: ``ops.solve_share``'s
own spans and reader."""
from harness import spec

SPANS = spec.metric_module("ops.solve_share").SPANS


def read(rec):
    return spec.metric_reader("ops.solve_share")(rec)
