"""Batched dense solves, batch lane-minor: A (n, n, B), b (n, R, B).

The PyTorch counterpart of ``hpfx/ops/batched_solve.py``.  Every float32
solve of the sweep is Gauss-Jordan elimination with *virtual* partial
pivoting, wrapped in row and column max-abs equilibration
(:func:`equilibrated_lanes`):

* per column k, pick the unused row with the largest |A[r, k]| (lowest
  index on ties, as ``argmax``);
* one fused rank-1 update ``[A | b] -= w ⊗ [A | b][p]`` with
  w = A[r, k]/piv off the pivot row and 1 − 1/piv on it eliminates the
  column and normalizes the pivot row at once;
* mark the pivot row used (a mask replaces the row permutation);
* after n steps A is a per-system permutation and x[k] = Σ_r A[r, k]·b[r].

:func:`gj_solve_lanes_ref` is that algorithm in plain PyTorch (the twin
of the Pallas kernels and of ``gj_solve_xla_lanes``).
:func:`gauss_solve_lanes` is the wrapper of the hand-written CUDA
kernels (``csrc/gj_solve.cu``; :func:`kernel_for` names the one a dim
takes, :func:`launch_plan` how it is launched, :data:`GJ_UNROLLED` picks
the unrolled variant for dims >= 64); it runs the plain twin only for
tensors that lie on the CPU.  :func:`equilibrated_gauss_solve_lanes` is
``equilibrated_lanes(gauss_solve_lanes)`` with the equilibration run
inside the kernel on the card.

Large dims take the blocked form of the same elimination
(:func:`panel_gj_solve_lanes`): one panel of columns at a time is
eliminated with pivots chosen over all rows (:func:`gj_panel_lanes`, the
wrapper of ``csrc/gj_panel.cu``; plain twin :func:`gj_panel_ref`), which
exports the panel's transform as Z and its pivot rows; a gather of the
pivot rows and one batched product apply it to the trailing columns and
the RHS.

:func:`schur_solve_lanes` is the panel-Schur block recursion of the same
file, whose leaves are the direct kernels with many right-hand sides
(:func:`chunked_plan` splits those past one block's shared memory or
register slots).

:func:`batched_solve_lanes` routes each solve as the JAX dispatcher does
(``hpfx/ops/batched_solve.py:748-790``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os
from typing import NamedTuple

import torch

from ..utils.profiling import spanned

#: dims <= this take the plain PyTorch elimination (the JAX package's
#: unrolled-XLA ``gj_solve_xla_lanes`` range)
XLA_GJ_MAX_DIM = 16
#: dims >= this take the one-block-per-system kernel (``_gj_kernel_carried``'s
#: range); below it the one-warp-per-system kernel (``_gj_kernel``'s)
KERNEL_SWITCH_DIM = 64
#: largest dim of the direct kernels (``MAX_PALLAS_DIM`` in the JAX package)
MAX_KERNEL_DIM = 192
#: dims above this use a blocked solve when ``impl`` is "panel" or
#: "schur" (or "auto" with HPFX_SCHUR=mid)
SCHUR_MIN_DIM = 128
#: panel width of the blocked solve (``PANEL_GJ_WIDTH`` in the JAX package)
PANEL_WIDTH = 32
#: the panel kernel's widths, each with the most padded rows it takes: a
#: thread keeps 32 register slots, one row of width 32, two of 16 or four of
#: 8, and a block has at most 1024 threads.  The blocked solve narrows its
#: panel to fit, as the reference narrows its own to fit VMEM
#: (``panel_gj_width_for``)
PANEL_LIMITS = ((32, 1024), (16, 2048), (8, 4096))
#: largest padded dim of the panel kernel.  Past it a float32 solve takes
#: ``equilibrated_lanes(_lu_solve_lanes)``.  The reference bounds its panel
#: by VMEM (``panel_gj_fits``: 9 slabs of Np x width x 128 floats within
#: ``VMEM_LIMIT``), so it runs its panel kernel at width 32 up to n = 768,
#: 24 up to 1056, 16 up to 1584 and 8 up to 3184, and takes LU from 3185
#: on (``hpfx/ops/batched_solve.py:779-780``).  The port runs K4 further,
#: to 4096 padded rows: between 3185 and 4096 the two take different
#: routes (K4 here, LU there), both pivoting over all rows.  The
#: panel-Schur solve (``impl="schur"``) has the same bound here, as it has
#: the panel's there
MAX_PANEL_DIM = PANEL_LIMITS[-1][1]
#: shared memory one block may use on Hopper, static and dynamic (bytes)
_SMEM_PER_BLOCK = 232448
#: ``gj_kernel``'s instantiations (``k1_instance`` in ``csrc/gj_solve.cu``):
#: (rows a lane keeps, register slots a row) with the right-hand sides in
#: the slots, and with them in shared memory (the slots then hold A only)
K1_INSTANCES = ((1, 32), (1, 96), (2, 40), (2, 56), (2, 64))
K1_SMEM_INSTANCES = ((1, 32), (2, 64))
#: ``gj_kernel_carried``'s (``k2_instance``): (padded rows, slots a row),
#: the right-hand sides always in the slots.  Each row count has a narrow
#: instantiation and a wide one; right-hand sides past the wide one are
#: split into chunks of columns (:func:`chunked_plan`)
K2_INSTANCES = ((64, 80), (64, 192), (96, 112), (96, 224), (128, 144),
                (128, 256), (160, 176), (160, 208), (192, 208))
#: ``gj_kernel_carried``: (threads a row, rows a thread) by (padded rows,
#: slots), (1, 1) where not listed.  A wide row is split over two or four
#: threads so that its slots fit the registers without spilling, and a
#: thread of the wide ones up to 160 rows keeps two rows, so that one read
#: of the staged pivot row feeds two rows' multiply-adds
K2_LAYOUT = {(64, 192): (4, 2), (96, 224): (4, 2), (128, 256): (4, 2),
             (160, 176): (2, 1), (160, 208): (4, 2), (192, 208): (2, 1)}
#: ``gj_kernel``: systems (warps) a block when a lane keeps one row; half
#: as many with two (``kMaxSystemsK1``)
_K1_SYSTEMS = 8

#: route dims >= KERNEL_SWITCH_DIM to ``gj_kernel_unrolled`` (the step
#: loop unrolled at compile time, a group of steps at a time) instead of
#: ``gj_kernel_carried``.  Read once at import from HPFX_GJ_UNROLLED=1, as
#: the JAX package reads it (``hpfx/ops/batched_solve.py:204``); off by
#: default
GJ_UNROLLED = os.environ.get("HPFX_GJ_UNROLLED", "0") == "1"
#: the panel width of :func:`schur_solve_lanes`, read once at import from
#: HPFX_SCHUR_PANEL (``hpfx/ops/batched_solve.py:657``)
SCHUR_PANEL = int(os.environ.get("HPFX_SCHUR_PANEL", "32"))
#: the blocked routes, read once at import from HPFX_SCHUR
#: (``hpfx/ops/batched_solve.py:667``): "1" (default) the panel solve past
#: the direct kernels' dims; "mid" the panel solve also above
#: SCHUR_MIN_DIM for ``impl="auto"``; "0" LU past the direct kernels' dims.
#: The panel-Schur solve is taken only with ``impl="schur"``
SCHUR_MODE = os.environ.get("HPFX_SCHUR", "1")
#: :func:`schur_solve_lanes` takes its leaf at dims up to panel + this
#: (``SUBLANE`` in the JAX package)
_SCHUR_LEAF_SLACK = 8

#: launches of each CUDA kernel since the last reset (reset by assigning 0)
LAUNCHES = {"gj_kernel": 0, "gj_kernel_carried": 0, "gj_kernel_unrolled": 0,
            "gj_panel_kernel": 0, "fused_trip_kernel": 0,
            "rectifier_kernel": 0}
#: the same launches by (kernel, shape) since the last ``clear()``: shape
#: (n, R, B) of a direct solve, (N, Pw, B) of a panel, (H, n, B) of a
#: fused trip, (S, steps + 1, substeps) of a rectifier time loop
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()


def _count_launch(name: str, shape) -> None:
    """Count one launch of kernel ``name`` at ``shape``."""
    LAUNCHES[name] += 1
    LAUNCHES_BY_SHAPE[(name, tuple(int(d) for d in shape))] += 1


def gj_solve_lanes_ref(A, b):
    """Virtual-pivot Gauss-Jordan in plain PyTorch: A (n, n, B),
    b (n, R, B) -> x (n, R, B), in the inputs' dtype.

    Same algorithm, pivot order and update formula as the Pallas kernels
    ``_gj_kernel``/``_gj_kernel_carried`` and ``gj_solve_xla_lanes``; the
    pivot row is gathered instead of reduced out with a one-hot mask
    (identical values for finite inputs)."""
    n, _, B = A.shape
    R = b.shape[1]
    rows = torch.arange(n, device=A.device)[:, None]
    used = torch.zeros((n, B), dtype=A.dtype, device=A.device)
    for k in range(n):
        colk = A[:, k, :]                                      # (n, B)
        p = torch.argmax(colk.abs() - 1e30 * used, dim=0)      # (B,)
        rowp = A.gather(0, p.view(1, 1, B).expand(1, n, B))[0]  # (n, B)
        bp = b.gather(0, p.view(1, 1, B).expand(1, R, B))[0]    # (R, B)
        inv_piv = 1.0 / colk.gather(0, p[None])[0]             # (B,)
        on_p = rows == p[None, :]                              # (n, B)
        w = torch.where(on_p, 1.0 - inv_piv[None, :], colk * inv_piv[None, :])
        A = A - w[:, None, :] * rowp[None, :, :]
        b = b - w[:, None, :] * bp[None, :, :]
        used = torch.maximum(used, on_p.to(A.dtype))
    return torch.einsum("kib,krb->irb", A, b)


class LaunchPlan(NamedTuple):
    """How ``gj_kernel`` or ``gj_kernel_carried`` solves one (n, R) shape
    on the card."""
    kernel: str       # "gj_kernel" or "gj_kernel_carried"
    rows: int         # gj_kernel: rows a lane keeps; carried: padded rows
    slots: int        # register slots a row keeps (the instantiation)
    b_in_smem: bool   # the right-hand sides in shared memory, not slots
    threads: int      # threads a block
    systems: int      # systems a block
    smem: int         # dynamic shared memory a block (bytes)


def launch_plan(n: int, R: int) -> LaunchPlan:
    """The launch of a dim-n solve with R right-hand sides by the kernel
    that takes dims below or from ``KERNEL_SWITCH_DIM`` (the instantiation
    tables :data:`K1_INSTANCES` and :data:`K2_INSTANCES`, mirrored in
    ``csrc/gj_solve.cu``):

    * ``gj_kernel`` (n < 64): one warp per system, a lane keeping one row
      (n <= 32) or two; 8 or 4 consecutive systems a block;
    * ``gj_kernel_carried`` (64 <= n <= 192): one system a block, a
      thread per row (for the wide rows two or four threads a row, a
      thread keeping one or two rows: :data:`K2_LAYOUT`), n padded to
      whole warps; ``gj_kernel_unrolled`` (:data:`GJ_UNROLLED`) takes the
      same plan;

    each with [A | b]'s row in the narrowest instantiation's slots that
    holds it; ``gj_kernel`` alone keeps A in the slots and b in shared
    memory where none does.  Raises ``ValueError``, naming the limit, for
    a shape no instantiation takes (:func:`chunked_plan` then splits R)."""
    if n < 1 or R < 1:
        raise ValueError(f"no solve of dim {n} with {R} right-hand sides")
    if n > MAX_KERNEL_DIM:
        raise ValueError(f"system dim {n} exceeds the direct kernels' "
                         f"{MAX_KERNEL_DIM}")
    if n >= KERNEL_SWITCH_DIM:
        rows = -(-n // 32) * 32
        fits = [w for r, w in K2_INSTANCES if r == rows and w >= n + R]
        if not fits:
            raise ValueError(
                f"dim {n} with {R} right-hand sides passes the register "
                f"slots of gj_kernel_carried's widest instantiation at "
                f"{rows} rows")
        slots = fits[0]
        per_row, per_thread = K2_LAYOUT.get((rows, slots), (1, 1))
        threads = rows * per_row // per_thread
        return LaunchPlan("gj_kernel_carried", rows, slots, False, threads,
                          1, 0)
    kernel, rows = "gj_kernel", (1 if n <= 32 else 2)
    systems, threads = _K1_SYSTEMS // rows, 32 * (_K1_SYSTEMS // rows)
    fits = [w for r, w in K1_INSTANCES if r == rows and w >= n + R]
    b_in_smem = not fits
    if b_in_smem:
        fits = [w for r, w in K1_SMEM_INSTANCES if r == rows and w >= n]
    slots = fits[0]
    # per warp: its b rows and its staged pivot b; statically the stages
    # and column scales of the warps
    smem = systems * (32 * rows * (R | 1) + 2 * R) * 4 if b_in_smem else 0
    static = 4 * systems * (2 * slots + 32 * rows)
    if smem + static > _SMEM_PER_BLOCK:
        raise ValueError(f"dim {n} with {R} right-hand sides needs "
                         f"{smem + static} bytes of shared memory per block "
                         f"(> {_SMEM_PER_BLOCK})")
    return LaunchPlan(kernel, rows, slots, b_in_smem, threads, systems, smem)


@functools.lru_cache(maxsize=None)
def _widest_chunk(n: int) -> int:
    """The most right-hand sides one block of the dim-n direct kernel takes
    (:func:`launch_plan` does not raise up to it, and raises past it)."""
    lo = 1
    while _fits(n, 2 * lo):
        lo *= 2
    hi = 2 * lo - 1         # lo fits and 2·lo does not
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _fits(n, mid) else (lo, mid - 1)
    return lo


def _fits(n: int, R: int) -> bool:
    try:
        launch_plan(n, R)
    except ValueError:
        return False
    return True


def chunked_plan(n: int, R: int) -> tuple[LaunchPlan, int]:
    """The one launch of a dim-n solve with any R >= 1 right-hand sides:
    (plan, chunk).  Each block solves its systems against ``chunk`` of the
    R columns (the last chunk may be narrower), the grid's y covering R;
    ``plan`` is :func:`launch_plan` at ``chunk``.  R up to the widest
    chunk one block takes is one chunk; past it R is split into as few
    chunks of near-equal width as fit.  With the pivots depending on A
    alone, every column sees the same multipliers in any chunk."""
    widest = _widest_chunk(n)
    chunk = -(-R // -(-R // widest))
    return launch_plan(n, chunk), chunk


def kernel_for(n: int) -> str:
    """The CUDA kernel that solves a dim-n system: ``gj_kernel`` below
    ``KERNEL_SWITCH_DIM``, above it ``gj_kernel_carried``, or
    ``gj_kernel_unrolled`` when :data:`GJ_UNROLLED` is set."""
    if n < KERNEL_SWITCH_DIM:
        return "gj_kernel"
    return "gj_kernel_unrolled" if GJ_UNROLLED else "gj_kernel_carried"


def fuses_equilibration(n: int) -> bool:
    """Whether the card's kernel for a dim-n solve runs the equilibration
    inside: every direct kernel does (``gj_kernel``, ``gj_kernel_carried``
    and ``gj_kernel_unrolled``)."""
    return 0 < n <= MAX_KERNEL_DIM


def _check_operands(A, b):
    """Shape, dtype, layout and device checks of the direct kernels."""
    if A.dim() != 3 or b.dim() != 3 or A.shape[0] != A.shape[1] \
            or b.shape[0] != A.shape[0] or b.shape[2] != A.shape[2]:
        raise ValueError(f"expected A (n, n, B) and b (n, R, B), got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the GJ kernels take float32, got {A.dtype}/{b.dtype}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("the GJ kernels take contiguous lane-major tensors")
    if A.shape[0] > MAX_KERNEL_DIM:
        raise ValueError(f"system dim {A.shape[0]} exceeds the direct "
                         f"kernels' {MAX_KERNEL_DIM}")
    if A.device != b.device:
        raise ValueError("A and b lie on different devices")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GJ kernel for device {A.device}")


def gauss_solve_lanes(A, b):
    """Solve A[:, :, i] x = b[:, :, i] for every lane i: A (n, n, B),
    b (n, R, B) float32, contiguous -> x (n, R, B) float32.

    A CUDA tensor runs the hand-written kernel :func:`kernel_for` names —
    ``gj_kernel`` (one warp per system) for n < 64, ``gj_kernel_carried``
    or ``gj_kernel_unrolled`` (one block per system) for 64 <= n <= 192
    — or raises.  A CPU tensor runs
    :func:`gj_solve_lanes_ref`.  No equilibration here: callers wrap it
    with :func:`equilibrated_lanes`, or call
    :func:`equilibrated_gauss_solve_lanes`."""
    _check_operands(A, b)
    if A.device.type == "cpu":
        return gj_solve_lanes_ref(A, b)
    x = torch.empty_like(b)
    _launch(A, b, x)
    return x


def equilibrated_gauss_solve_lanes(A, b):
    """``equilibrated_lanes(gauss_solve_lanes)(A, b)`` with the row and
    column equilibration inside the kernel: the same float operations in
    the same order, and no scaled copy of A.

    A CUDA tensor launches the kernel :func:`kernel_for` names with the
    equilibration on; a CPU tensor runs
    ``equilibrated_lanes(gj_solve_lanes_ref)``."""
    _check_operands(A, b)
    if A.device.type == "cpu":
        return equilibrated_lanes(gj_solve_lanes_ref)(A, b)
    x = torch.empty_like(b)
    _launch(A, b, x, equilibrate=True)
    return x


def _launch(A, b, x, equilibrate: bool = False):
    """Launch the kernel for ``n`` on the current stream, with the
    equilibration inside when ``equilibrate``: one launch at any R, as
    :func:`chunked_plan` plans it.  Operands may have any element strides
    (the kernels index with them)."""
    from ._build import load_library
    n, _, B = A.shape
    R = b.shape[1]
    if B == 0:
        return
    name = kernel_for(n)
    p, chunk = chunked_plan(n, R)
    plan = [p.rows, p.slots, int(p.b_in_smem), p.threads, p.systems]
    plan = [ctypes.c_int(v) for v in plan + [int(equilibrate), p.smem, chunk]]
    lib = load_library()
    fn = getattr(lib, f"hpfx_{name}")
    st = lambda t: [ctypes.c_longlong(s) for s in t.stride()]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = fn(ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(b.data_ptr()),
                 ctypes.c_void_p(x.data_ptr()), ctypes.c_int(n),
                 ctypes.c_int(R), ctypes.c_longlong(B),
                 *st(A), *st(b), *st(x), *plan, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"GJ kernel launch failed (cudaError {err}: "
            f"{lib.hpfx_error_string(err).decode()}) at n={n}, R={R}, B={B}")
    _count_launch(name, (n, R, B))


def equilibrated_lanes(solve):
    """Wrap a lane-major solver with row+column max-abs equilibration:
    D_r·A·D_c x' = D_r·b, x = D_c·x' (exact in exact arithmetic; keeps
    f32 pivoting well scaled on HPF Jacobians that mix O(1) power rows
    with O(|Y|) current rows)."""
    # the max-abs norms reduce |A| without writing it out
    amax_abs = lambda X, d: torch.linalg.vector_norm(X, float("inf"), dim=d)

    def wrapped(A, b):
        r = 1.0 / torch.clamp_min(amax_abs(A, 1), 1e-30)           # (n, B)
        As = A * r[:, None, :]
        c = 1.0 / torch.clamp_min(amax_abs(As, 0), 1e-30)
        As.mul_(c[None, :, :])
        x = solve(As, b * r[:, None, :])
        return x * c[:, None, :]
    return wrapped


def _lu(A, b):
    """LAPACK/cuSOLVER LU, ``torch.linalg.solve`` without its error check:
    a singular system gives a non-finite solution, as ``jnp.linalg.solve``
    does (the Newton loop then leaves that scenario unconverged), where
    ``torch.linalg.solve`` raises for the whole batch (and syncs with the
    host to find out)."""
    return torch.linalg.solve_ex(A, b)[0]


def _lu_solve_lanes(A, b):
    """LAPACK/cuSOLVER LU for lane-major operands (the float64 path)."""
    x = _lu(A.permute(2, 0, 1), b.permute(2, 0, 1))
    return x.permute(1, 2, 0)


def gj_panel_ref(panel, used):
    """One panel of the blocked Gauss-Jordan solve in plain PyTorch, as
    ``csrc/gj_panel.cu`` computes it: panel (N, Pw, B), the 0/1 ``used``
    mask (N, B) -> (Z, piv, used_out): Z (N, Pw, B), the pivot rows piv
    (Pw, B) int32 and the updated mask.

    For each column k the pivot is the unused row with the largest
    |A[r, k]| over all N rows; one rank-1 update eliminates the columns
    after k and carries Z = T·E − E (T the panel's composite row
    transform, E the one-hot pivot columns) on the columns up to k.  One
    slot per column holds A[:, c] before step c and Z[:, c] from step c
    on: the TPU kernel ``_gj_panel_kernel``
    (``hpfx/ops/batched_solve.py:452-510``) also updates A's eliminated
    columns and T·E's zero ones, which changes no pivot and only moves Z
    by rounding.  :func:`expand_panel` rebuilds its outputs."""
    N, Pw, B = panel.shape
    rows = torch.arange(N, device=panel.device)[:, None]
    S = panel
    piv = torch.empty((Pw, B), dtype=torch.int32, device=panel.device)
    for k in range(Pw):
        colk = S[:, k, :]                                      # (N, B)
        p = torch.argmax(colk.abs() - 1e30 * used, dim=0)      # (B,)
        on_p = rows == p[None, :]                              # (N, B)
        rowp = S.gather(0, p.view(1, 1, B).expand(1, Pw, B))[0]  # (Pw, B)
        inv_piv = 1.0 / rowp[k]                                # (B,)
        w = torch.where(on_p, 1.0 - inv_piv[None, :], colk * inv_piv[None, :])
        S = S - w[:, None, :] * rowp[None, :, :]
        S[:, k, :] = -w
        used = torch.maximum(used, on_p.to(used.dtype))
        piv[k] = p.to(torch.int32)
    return S, piv, used


def expand_panel(Z, piv):
    """The TPU kernel's outputs from :func:`gj_panel_ref`'s: Z (N, Pw, B)
    and the pivot rows piv (Pw, B) -> (Ap, TE, E), each (N, Pw, B).  E
    holds the one-hot pivot columns, TE = Z + E, and Ap (the converged
    panel, a permutation up to rounding) is E."""
    N = Z.shape[0]
    rows = torch.arange(N, device=Z.device)[:, None, None]
    E = (rows == piv[None].long()).to(Z.dtype)
    return E, Z + E, E


#: the blocked solve's buffer pads its rows to a multiple of this many
#: floats (128 bytes, zero past the right-hand sides), so that the trailing
#: products read and write aligned rows (faster on the H100 at every net1
#: dim than pitches of 1, 4 or 8 floats)
_ROW_PITCH = 32
#: the blocked solve copies A into its buffer in slices of rows of at most
#: this many bytes, so that the strided reads of a slice meet in the cache
#: (on the H100 several times faster at dim 780, B=128, and no slower at
#: dim 182, B=2048; 16 MiB slices were slower at both)
_FILL_BYTES = 64 << 20


def panel_width_for(n: int, panel: int = PANEL_WIDTH) -> int:
    """The panel width of a dim-``n`` blocked solve: the widest of the
    kernel's widths (:data:`PANEL_LIMITS`), no wider than ``panel``, at
    which n padded to whole panels fits the kernel; 0 past
    :data:`MAX_PANEL_DIM` padded rows (callers then take LU).  The plain
    twin takes the same width, so both devices follow one route."""
    for w, rows in PANEL_LIMITS:
        if w <= panel and -(-n // w) * w <= rows:
            return w
    return 0


def _lanes_view(shape, batch_major: bool, dtype, device):
    """An empty tensor of lane-major ``shape`` (..., B), stored
    batch-major (B, ...) when ``batch_major``."""
    if not batch_major:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty((shape[-1], *shape[:-1]), dtype=dtype, device=device)
    return t.movedim(0, -1)


def gj_panel_lanes(panel, used):
    """Eliminate one panel: panel (N, Pw, B) float32 with any strides (a
    column slice of the padded matrix), ``used`` (N, B) float32 ->
    (Z, piv, used_out) as :func:`gj_panel_ref` returns them, each new
    and stored batch-major when the panel is (its system stride the
    largest), lane-major otherwise.

    A CUDA tensor launches ``gj_panel_kernel`` (``csrc/gj_panel.cu``,
    one block per system, (Pw, most rows) in :data:`PANEL_LIMITS`) or
    raises; a CPU tensor runs :func:`gj_panel_ref`, at any width."""
    if panel.dim() != 3 or used.dim() != 2 or used.shape[0] != panel.shape[0] \
            or used.shape[1] != panel.shape[2]:
        raise ValueError(f"expected panel (N, Pw, B) and used (N, B), got "
                         f"{tuple(panel.shape)} and {tuple(used.shape)}")
    if panel.dtype != torch.float32 or used.dtype != torch.float32:
        raise TypeError(f"the panel kernel takes float32, got "
                        f"{panel.dtype}/{used.dtype}")
    if panel.device != used.device:
        raise ValueError("panel and used lie on different devices")
    if panel.device.type == "cpu":
        return gj_panel_ref(panel, used)
    if panel.device.type != "cuda":
        raise ValueError(f"no panel kernel for device {panel.device}")
    N, Pw, B = panel.shape
    if N > dict(PANEL_LIMITS).get(Pw, 0) or Pw > N:
        raise ValueError(f"panel ({N}, {Pw}): the kernel takes (width, most "
                         f"rows) {PANEL_LIMITS}")
    bm = panel.stride(2) > panel.stride(0)
    dv = panel.device
    Z = _lanes_view((N, Pw, B), bm, torch.float32, dv)
    piv = _lanes_view((Pw, B), bm, torch.int32, dv)
    used_out = _lanes_view((N, B), bm, torch.float32, dv)
    if B > 0:
        _launch_panel(panel, used, Z, piv, used_out)
    return Z, piv, used_out


def _launch_panel(panel, used, Z, piv, used_out):
    from ._build import load_library
    N, Pw, B = panel.shape
    lib = load_library()
    st = lambda t: [ctypes.c_longlong(s) for s in t.stride()]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(panel.device).cuda_stream
    with torch.cuda.device(panel.device):
        err = lib.hpfx_gj_panel_kernel(
            ptr(panel), ptr(used), ptr(Z), ptr(piv), ptr(used_out),
            ctypes.c_int(N), ctypes.c_int(Pw), ctypes.c_longlong(B),
            *st(panel), *st(Z), *st(piv), *st(used), *st(used_out),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"panel kernel launch failed (cudaError {err}: "
            f"{lib.hpfx_error_string(err).decode()}) at N={N}, Pw={Pw}, "
            f"B={B}")
    _count_launch("gj_panel_kernel", (N, Pw, B))


def panel_gj_solve_lanes(A, b, panel: int = PANEL_WIDTH):
    """Blocked Gauss-Jordan solve with full partial pivoting, lane-major:
    A (n, n, B), b (n, R, B) float32 -> x (n, R, B)
    (``hpfx/ops/batched_solve.py:575-642``).

    [A | b] is copied once, batch-major, into one buffer (B, Np, W),
    padded to Np, a multiple of the panel width (:func:`panel_width_for`,
    which narrows ``panel`` to fit the kernel; past its rows this raises):
    identity on the pad rows and columns, so each pad column picks its own
    pad row, and zero right-hand sides there.  The row pitch W >= Np + R
    is a multiple of 32 floats, zero past the right-hand sides, of which
    the trailing products take R rounded up to 8.  Each panel is
    eliminated by :func:`gj_panel_lanes` in place in that buffer, pivoting
    over all rows with the ``used`` mask carried across panels, so the
    pivots are those of the direct elimination.  Its transform
    T = I + Z·Eᵀ is applied to the columns after it, the right-hand sides
    included: the rows at the panel's pivots are gathered (Eᵀ·trail) and
    one batched product (float32, TF32 off) adds Z times them.  A_final is
    the pivot permutation, so x is the final right-hand side gathered at
    the pivot sequence."""
    n, _, Bt = A.shape
    R = b.shape[1]
    panel = panel_width_for(n, panel)
    if panel == 0:
        raise ValueError(f"system dim {n} exceeds the panel kernel's "
                         f"{MAX_PANEL_DIM} padded rows; batched_solve_lanes "
                         "takes LU there")
    Np = -(-n // panel) * panel
    f32, dv = torch.float32, A.device

    W = -(-(Np + R) // _ROW_PITCH) * _ROW_PITCH
    end = Np + -(-R // 8) * 8   # the columns the trailing products take
    M = torch.empty((Bt, Np, W), dtype=f32, device=dv)
    step = max(1, _FILL_BYTES // max(1, 4 * n * Bt))
    for i in range(0, n, step):
        M[:, i:min(i + step, n), :n] = A[i:i + step].permute(2, 0, 1)
    M[:, :n, Np:Np + R] = b.permute(2, 0, 1)
    M[:, :n, Np + R:] = 0.0
    if Np > n:
        M[:, :n, n:Np] = 0.0
        M[:, n:] = 0.0
        M[:, n:, n:Np] = torch.eye(Np - n, dtype=f32, device=dv)
    used = torch.zeros((Bt, Np), dtype=f32, device=dv).t()
    order = torch.empty((Bt, Np), dtype=torch.int64, device=dv)
    for lo in range(0, Np, panel):
        hi = lo + panel
        Z, piv, used = gj_panel_lanes(M[:, :, lo:hi].permute(1, 2, 0), used)
        order[:, lo:hi] = piv.t()
        trail = M[:, :, hi:end]                 # (B, Np, J), J a multiple of 8
        rows = trail.gather(1, order[:, lo:hi, None].expand(-1, -1,
                                                             trail.shape[2]))
        trail.baddbmm_(Z.permute(2, 0, 1), rows)
    x = M[:, :, Np:Np + R].gather(1, order[:, :n, None].expand(-1, -1, R))
    return x.permute(1, 2, 0).contiguous().to(A.dtype)


def schur_solve_lanes(A, b, leaf=None, panel: int = SCHUR_PANEL):
    """Blocked (right-looking) panel-Schur solve, lane-major: A (n, n, B),
    b (n, R, B) -> x (n, R, B) (``hpfx/ops/batched_solve.py:670-724``).

    The block recursion of the reference, with panel width ``panel``:

        A11 [X12 | y1] = [A12 | b1]      one leaf solve, dim panel
        S = A22 - A21 X12, rhs2 = b2 - A21 y1
        S x2 = rhs2                      the same on the trailing system
        x1 = y1 - X12 x2

    down to a trailing system of at most panel + 8 rows, which the leaf
    solves whole.  The leaf pivots within its own rows only (block LU with
    block-diagonal pivoting), so a column whose mass lies outside its
    panel draws a small pivot: callers equilibrate first (the dispatcher
    does), and Newton steps converge less often than with the panel solve
    (``Settings.big_solve``).

    Here the recursion is a loop over the levels in one batch-major buffer
    [A | b] (B, n, n + R), copied once: each level writes [X12 | y1] over
    its panel's rows, one batched product (float32, TF32 off) updates the
    trailing [S | rhs2] in place with ``baddbmm_``, and a second loop adds
    -X12 x2 to each y1 from the last level up.

    ``leaf`` (n, n, B), (n, R, B) -> (n, R, B) gets contiguous lane-major
    operands; it defaults to :func:`gauss_solve_lanes` without the
    equilibration: on the card the direct kernel :func:`kernel_for` names
    (``gj_kernel`` at the default panel of 32, one launch at any R, see
    :func:`chunked_plan`), on the CPU the plain twin."""
    if leaf is None:
        leaf = gauss_solve_lanes
    n, _, Bt = A.shape
    R = b.shape[1]
    if n <= panel + _SCHUR_LEAF_SLACK:
        return leaf(A.contiguous(), b.contiguous())
    lanes = lambda t: t.permute(1, 2, 0).contiguous()
    M = torch.empty((Bt, n, n + R), dtype=A.dtype, device=A.device)
    M[:, :, :n] = A.permute(2, 0, 1)
    M[:, :, n:] = b.permute(2, 0, 1)
    starts = range(0, n - panel - _SCHUR_LEAF_SLACK, panel)
    for lo in starts:
        hi = lo + panel
        M[:, lo:hi, hi:] = leaf(lanes(M[:, lo:hi, lo:hi]),
                                lanes(M[:, lo:hi, hi:])).permute(2, 0, 1)
        M[:, hi:, hi:].baddbmm_(M[:, hi:, lo:hi], M[:, lo:hi, hi:],
                                alpha=-1.0)
    last = starts[-1] + panel
    x = torch.empty((Bt, n, R), dtype=A.dtype, device=A.device)
    x[:, last:] = leaf(lanes(M[:, last:, last:n]),
                       lanes(M[:, last:, n:])).permute(2, 0, 1)
    for lo in reversed(starts):
        hi = lo + panel
        x[:, lo:hi] = torch.baddbmm(M[:, lo:hi, n:], M[:, lo:hi, hi:n],
                                    x[:, hi:], alpha=-1.0)
    return x.permute(1, 2, 0).contiguous()


@spanned("solve")
def batched_solve_lanes(A, b, impl: str = "auto"):
    """Lane-major batched solve: A (n, n, B), b (n, R, B) -> x (n, R, B).

    Routes as ``hpfx.ops.batched_solve.batched_solve_lanes`` does on its
    TPU (``hpfx/ops/batched_solve.py:751-787``), on either device: float64
    goes to LU (:func:`_lu`); float32 is equilibrated and goes to

    * n <= 16: the plain elimination;
    * n > 192: LU where :data:`SCHUR_MODE` is "0" or n passes
      :data:`MAX_PANEL_DIM` padded rows (the reference's own bound is
      n = 3184), else :func:`schur_solve_lanes` with ``impl="schur"`` and
      the blocked panel solve (:func:`panel_gj_solve_lanes`) otherwise;
    * 128 < n <= 192: :func:`schur_solve_lanes` with ``impl="schur"``, the
      panel solve with ``impl="panel"`` or with "auto" under
      ``SCHUR_MODE == "mid"``;
    * otherwise :func:`equilibrated_gauss_solve_lanes` (``gj_kernel`` for
      n < 64, ``gj_kernel_carried`` up to 192; on the card the
      equilibration runs inside them).

    Each call is one ``hpfx.solve`` span under a profiler."""
    n = A.shape[0]
    if A.dtype == torch.float64:
        return _lu_solve_lanes(A, b)
    if n <= XLA_GJ_MAX_DIM:
        return equilibrated_lanes(gj_solve_lanes_ref)(A, b)
    if n > MAX_KERNEL_DIM:
        if SCHUR_MODE == "0" or panel_width_for(n) == 0:
            return equilibrated_lanes(_lu_solve_lanes)(A, b)
        if impl == "schur":
            return equilibrated_lanes(schur_solve_lanes)(A, b)
        return equilibrated_lanes(panel_gj_solve_lanes)(A, b)
    if impl == "schur" and n > SCHUR_MIN_DIM:
        return equilibrated_lanes(schur_solve_lanes)(A, b)
    want_panel = impl == "panel" or (impl == "auto" and SCHUR_MODE == "mid")
    if want_panel and n > SCHUR_MIN_DIM:
        return equilibrated_lanes(panel_gj_solve_lanes)(A, b)
    return equilibrated_gauss_solve_lanes(A.contiguous(), b.contiguous())


# ---------------------------------------------------------------------------
# batch-major solves: A (B, n, n), b (B, n) or (B, n, R)
# ---------------------------------------------------------------------------

def equilibrated(solve):
    """Batch-major twin of :func:`equilibrated_lanes`: wrap a solver of
    A (..., n, n), b (..., n) or (..., n, R) with row and column max-abs
    equilibration, D_r·A·D_c x' = D_r·b, x = D_c·x'
    (``hpfx.ops.batched_solve.equilibrated``)."""
    amax_abs = lambda X, d: torch.linalg.vector_norm(X, float("inf"), dim=d)

    def wrapped(A, b):
        multi = b.dim() == A.dim()
        r = 1.0 / torch.clamp_min(amax_abs(A, -1), 1e-30)          # (..., n)
        As = A * r[..., :, None]
        c = 1.0 / torch.clamp_min(amax_abs(As, -2), 1e-30)
        As.mul_(c[..., None, :])
        x = solve(As, b * (r[..., :, None] if multi else r))
        return x * (c[..., :, None] if multi else c)
    return wrapped


def _lu_solve(A, b):
    """LAPACK/cuSOLVER LU, batch-major; b (..., n) or (..., n, R)."""
    if b.dim() == A.dim():
        return _lu(A, b)
    return _lu(A, b[..., None])[..., 0]


def _gauss_solve_batch_major(A, b):
    """The direct kernels on batch-major operands: one copy moves the
    batch last (``gauss_solve_pallas``, ``hpfx/ops/batched_solve.py:248-
    280``), then :func:`equilibrated_gauss_solve_lanes` solves with the
    equilibration inside ``gj_kernel`` (n < 64) or ``gj_kernel_carried``
    (``gj_kernel_unrolled`` under :data:`GJ_UNROLLED`) on the card, and
    ``equilibrated_lanes(gj_solve_lanes_ref)`` on the CPU.  The kernels
    take any dim from 1: a system's pad rows and slots are zero and never
    pivot."""
    multi = b.dim() == A.dim()
    b3 = b if multi else b[..., None]
    x = equilibrated_gauss_solve_lanes(A.permute(1, 2, 0).contiguous(),
                                       b3.permute(1, 2, 0).contiguous())
    x = x.permute(2, 0, 1)
    return x if multi else x[..., 0]


def _panel_gj_batch_major(A, b):
    """:func:`panel_gj_solve_lanes` on batch-major operands: the blocked
    solve copies A into its batch-major buffer anyway, so the lane-major
    view of A is read as it stands."""
    multi = b.dim() == A.dim()
    b3 = b if multi else b[..., None]
    x = panel_gj_solve_lanes(A.permute(1, 2, 0), b3.permute(1, 2, 0))
    x = x.permute(2, 0, 1)
    return x if multi else x[..., 0]


def batched_solve(A, b):
    """Batch-major batched solve: A (B, n, n), b (B, n) or (B, n, R)
    (``hpfx.ops.batched_solve.batched_solve``).

    float64 goes to LU (:func:`_lu`) raw, as in the JAX
    package.  float32 takes the JAX package's TPU branch on either device:
    equilibrated, n <= 192 goes to the direct kernels
    (:func:`_gauss_solve_batch_major`: ``gj_kernel`` below 64, with no
    split at dim 16, ``gj_kernel_carried`` from 64), larger dims to the
    blocked panel solve (:func:`_panel_gj_batch_major`, K4) up to
    :data:`MAX_PANEL_DIM` padded rows and to LU past them, or under
    ``SCHUR_MODE == "0"``.  On the CPU
    the kernels' plain twins run.  This departs from the JAX package on
    the CPU, whose float32 branch there takes equilibrated LU."""
    n = A.shape[-1]
    if A.dtype == torch.float64:
        return _lu_solve(A, b)
    if n > MAX_KERNEL_DIM:
        if SCHUR_MODE == "0" or panel_width_for(n) == 0:
            return equilibrated(_lu_solve)(A, b)
        return equilibrated(_panel_gj_batch_major)(A, b)
    return _gauss_solve_batch_major(A, b)


def solve_blocks(D, rhs):
    """Uniform multi-RHS block solves: D (..., H, k, k), rhs (..., H, k, R)
    -> (..., H, k, R) (``hpfx.ops.batched_solve.solve_blocks`` with its
    batching rule): every leading axis joins one batch of
    :func:`batched_solve`; float64 keeps the raw LU."""
    if D.dtype == torch.float64:
        return _lu(D, rhs)
    k, R = D.shape[-1], rhs.shape[-1]
    out = batched_solve(D.reshape(-1, k, k), rhs.reshape(-1, k, R))
    return out.reshape(rhs.shape)


def nr_solve(J, f):
    """The Newton linear solve J·dx = f: J (..., n, n), f (..., n) ->
    (..., n) (``hpfx.ops.batched_solve.nr_solve`` with its batching rule).
    float64 keeps the raw LU; float32 sends the whole batch (a single
    system is a batch of one) through :func:`batched_solve`."""
    if J.dtype == torch.float64:
        return _lu(J, f[..., None])[..., 0]
    n = J.shape[-1]
    out = batched_solve(J.reshape(-1, n, n), f.reshape(-1, n))
    return out.reshape(f.shape)
