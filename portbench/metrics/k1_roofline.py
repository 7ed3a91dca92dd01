"""K1 (``gj_kernel``, ``ops/csrc/gj_solve.cu``) against its roofline over
the device segment's calls: the summed least time of its launches, each
shape's bytes and operations (``harness.roofline.solve_work``), over its
summed device time, in percent."""
from harness import roofline, trace

KERNEL = "gj_kernel"


def read(rec):
    d = rec["device"]
    if d is None:
        return None
    launches = {shape: c for (k, shape), c in d["launches"].items()
                if k == KERNEL}
    us = trace.kernel_us(d["by_name"], KERNEL)
    if not launches or not us:
        return None
    return 100.0 * roofline.bound_seconds(KERNEL, launches) / (us / 1e6)
