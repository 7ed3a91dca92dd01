"""Share of the device's busy time, over the span segment's calls, taken
by the work launched inside the arrow step's capacitance solve
(``lanes.solve_capacitance_lanes``: the Woodbury system of every lane,
the direct kernels or the blocked panel solve by its dimension).  A
program without that function has nothing to read."""
import hpfx_torch.lanes

FUNCTION = "solve_capacitance_lanes"
SPANS = (f"hpfx_torch.lanes:{FUNCTION}",) \
    if hasattr(hpfx_torch.lanes, FUNCTION) else ()


def read(rec):
    sp = rec["spans"]
    if sp is None or not sp["busy_us"] or FUNCTION not in sp["under"]:
        return None
    return sp["under"][FUNCTION] / sp["busy_us"]
