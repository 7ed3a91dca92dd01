"""The least time a kernel's work could take on one NVIDIA H100 (SXM).

Peaks from NVIDIA's data sheet at the card's full 700 W: 3.35 TB/s of HBM
bandwidth and 67 TFLOP/s of float32 outside the tensor cores.  A kernel's
bound is the larger of its bytes over the bandwidth and its operations
over the float32 rate; its roofline share is that bound over its measured
time.  Bytes count each input read once and each output written once.
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12


def bound(nbytes: float, flops: float):
    """(seconds, "bytes" or "operations"): the least time for work that
    moves ``nbytes`` and does ``flops`` float32 operations."""
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def lu_flops(n: int, R: int) -> float:
    """Operations of one dense solve with R right-hand sides at the least a
    solve needs: an LU factorization and two triangular solves."""
    return 2 * n ** 3 / 3 + 2 * n * n * R


def solve_work(n: int, R: int, B: int):
    """(bytes, operations) of B dense float32 solves of dim n with R
    right-hand sides: A and b read, x written, once."""
    return 4 * B * (n * n + 2 * n * R), B * lu_flops(n, R)


def panel_work(N: int, Pw: int, B: int):
    """(bytes, operations) of B eliminations of one (N, Pw) panel: the
    panel and the row mask read; Z, the mask and the Pw pivot rows
    written; Pw steps of Pw multiply-adds per row."""
    return 4 * B * (2 * N * Pw + 2 * N + Pw), 2 * B * N * Pw * Pw


#: the work of a launch of each kernel at the shape the program counts
#: (``LAUNCHES_BY_SHAPE``): (n, R, B) for a direct solve, (N, Pw, B) for
#: a panel
WORK = {
    "gj_kernel": solve_work,
    "gj_kernel_carried": solve_work,
    "gj_kernel_unrolled": solve_work,
    "gj_panel_kernel": panel_work,
}


def bound_seconds(kernel: str, launches) -> float:
    """The summed bound of ``launches``, {shape: count}, of ``kernel``."""
    work = WORK[kernel]
    return sum(count * bound(*work(*shape))[0]
               for shape, count in launches.items())

