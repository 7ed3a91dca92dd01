"""K1 (``gj_kernel``) against its roofline in the one-card net2 cell at
65536 scenarios a call, where its capacitance solves are (26, 1, 65536):
``k1_roofline``'s own reader."""
from harness import spec


def read(rec):
    return spec.metric_reader("k1_roofline")(rec)
