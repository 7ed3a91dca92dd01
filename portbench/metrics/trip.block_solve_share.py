"""Share of the device's busy time, over the span segment's calls, taken
by the work launched inside the arrow step's block solves
(``lanes.solve_arrow_blocks_lanes``: every harmonic's block of every lane
in one batched solve, K1 or K2 on the card).  A program without that
function has nothing to read."""
import hpfx_torch.lanes

FUNCTION = "solve_arrow_blocks_lanes"
SPANS = (f"hpfx_torch.lanes:{FUNCTION}",) \
    if hasattr(hpfx_torch.lanes, FUNCTION) else ()


def read(rec):
    sp = rec["spans"]
    if sp is None or not sp["busy_us"] or FUNCTION not in sp["under"]:
        return None
    return sp["under"][FUNCTION] / sp["busy_us"]
