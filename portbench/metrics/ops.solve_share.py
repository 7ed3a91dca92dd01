"""Share of the device's busy time, over the span segment's calls, taken
by the work launched inside the batched solves (``lanes.
batched_solve_lanes``: equilibration, layout copies, the direct kernels,
and the blocked panel solve inside it)."""

SPANS = ("hpfx_torch.lanes:batched_solve_lanes",
         "hpfx_torch.ops.batched_solve:panel_gj_solve_lanes")


def read(rec):
    sp = rec["spans"]
    if sp is None or not sp["busy_us"]:
        return None
    return sp["under"]["*"] / sp["busy_us"]
