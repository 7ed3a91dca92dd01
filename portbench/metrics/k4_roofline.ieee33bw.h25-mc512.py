"""K4 (``gj_panel_kernel``) against its roofline in the IEEE 33-bus
feeder's cell, where the capacitance system is 832 wide:
``k4_roofline``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("k4_roofline")(rec)
