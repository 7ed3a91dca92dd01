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
kernels (``csrc/gj_solve.cu``); it runs the plain twin only for tensors
that lie on the CPU.  :func:`batched_solve_lanes` routes each solve as
the JAX dispatcher does (``hpfx/ops/batched_solve.py:748-790``).
"""
from __future__ import annotations

import ctypes

import torch

#: dims <= this take the plain PyTorch elimination (the JAX package's
#: unrolled-XLA ``gj_solve_xla_lanes`` range)
XLA_GJ_MAX_DIM = 16
#: dims >= this take the one-block-per-system kernel (``_gj_kernel_carried``'s
#: range); below it the one-warp-per-system kernel (``_gj_kernel``'s)
KERNEL_SWITCH_DIM = 64
#: largest dim of the direct kernels (``MAX_PALLAS_DIM`` in the JAX package)
MAX_KERNEL_DIM = 192
#: dims above this use the blocked panel solve when ``impl="panel"``
SCHUR_MIN_DIM = 128
#: dynamic shared memory one block may use on Hopper (bytes): 227 KB less
#: room for the kernels' static shared words
_MAX_SMEM = 232448 - 1024
#: systems (warps) per block of the one-warp-per-system kernel
_WARPS_PER_BLOCK = 4

#: launches of each CUDA kernel since the last reset (reset by assigning 0)
LAUNCHES = {"gj_kernel": 0, "gj_kernel_carried": 0}


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


def _kernel_smem(n: int, R: int, systems_per_block: int) -> int:
    """Dynamic shared memory of one block: per system the [A | b] rows at
    an odd leading dimension plus one staged pivot row (bytes)."""
    ld = (n + R) | 1
    return systems_per_block * (n + 1) * ld * 4


def gauss_solve_lanes(A, b):
    """Solve A[:, :, i] x = b[:, :, i] for every lane i: A (n, n, B),
    b (n, R, B) float32, contiguous -> x (n, R, B) float32.

    A CUDA tensor runs the hand-written kernel — ``gj_kernel`` (one warp
    per system) for n < 64, ``gj_kernel_carried`` (one block per system)
    for 64 <= n <= 192 — or raises.  A CPU tensor runs
    :func:`gj_solve_lanes_ref`.  No equilibration here: callers wrap it
    with :func:`equilibrated_lanes`."""
    if A.dim() != 3 or b.dim() != 3 or A.shape[0] != A.shape[1] \
            or b.shape[0] != A.shape[0] or b.shape[2] != A.shape[2]:
        raise ValueError(f"expected A (n, n, B) and b (n, R, B), got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the GJ kernels take float32, got {A.dtype}/{b.dtype}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("the GJ kernels take contiguous lane-major tensors")
    n, _, B = A.shape
    R = b.shape[1]
    if n > MAX_KERNEL_DIM:
        raise ValueError(f"system dim {n} exceeds the direct kernels' "
                         f"{MAX_KERNEL_DIM}")
    if A.device != b.device:
        raise ValueError("A and b lie on different devices")
    if A.device.type == "cpu":
        return gj_solve_lanes_ref(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"no GJ kernel for device {A.device}")
    x = torch.empty((n, R, B), dtype=torch.float32, device=A.device)
    _launch(A, b, x)
    return x


def _launch(A, b, x):
    """Launch the kernel for ``n`` on the current stream.  Operands may
    have any element strides (the kernels index with them)."""
    from ._build import load_library
    n, _, B = A.shape
    R = b.shape[1]
    if B == 0:
        return
    carried = n >= KERNEL_SWITCH_DIM
    spb = 1 if carried else _WARPS_PER_BLOCK
    smem = _kernel_smem(n, R, spb)
    if smem > _MAX_SMEM:
        raise ValueError(f"dim {n} with {R} right-hand sides needs {smem} "
                         f"bytes of shared memory per block (> {_MAX_SMEM})")
    lib = load_library()
    fn = lib.hpfx_gj_kernel_carried if carried else lib.hpfx_gj_kernel
    st = lambda t: [ctypes.c_longlong(s) for s in t.stride()]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = fn(ctypes.c_void_p(A.data_ptr()), ctypes.c_void_p(b.data_ptr()),
                 ctypes.c_void_p(x.data_ptr()), ctypes.c_int(n),
                 ctypes.c_int(R), ctypes.c_longlong(B),
                 *st(A), *st(b), *st(x), ctypes.c_int(smem),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"GJ kernel launch failed (cudaError {err}: "
            f"{lib.hpfx_error_string(err).decode()}) at n={n}, R={R}, B={B}")
    LAUNCHES["gj_kernel_carried" if carried else "gj_kernel"] += 1


def equilibrated_lanes(solve):
    """Wrap a lane-major solver with row+column max-abs equilibration:
    D_r·A·D_c x' = D_r·b, x = D_c·x' (exact in exact arithmetic; keeps
    f32 pivoting well scaled on HPF Jacobians that mix O(1) power rows
    with O(|Y|) current rows)."""
    def wrapped(A, b):
        r = 1.0 / torch.clamp_min(A.abs().amax(dim=1), 1e-30)      # (n, B)
        As = A * r[:, None, :]
        c = 1.0 / torch.clamp_min(As.abs().amax(dim=0), 1e-30)
        As = As * c[None, :, :]
        x = solve(As, b * r[:, None, :])
        return x * c[:, None, :]
    return wrapped


def _lu_solve_lanes(A, b):
    """LAPACK/cuSOLVER LU for lane-major operands (the float64 path)."""
    x = torch.linalg.solve(A.permute(2, 0, 1), b.permute(2, 0, 1))
    return x.permute(1, 2, 0)


def _kernel_solve(A, b):
    return gauss_solve_lanes(A.contiguous(), b.contiguous())


def batched_solve_lanes(A, b, impl: str = "auto"):
    """Lane-major batched solve: A (n, n, B), b (n, R, B) -> x (n, R, B).

    Routes as ``hpfx.ops.batched_solve.batched_solve_lanes`` does: float64
    goes to LU (``torch.linalg.solve``); float32 is equilibrated and goes
    to the plain elimination for n <= 16, to the ``gj_kernel`` wrapper for
    16 < n < 64 and to the ``gj_kernel_carried`` wrapper for
    64 <= n <= 128 (up to 192 with ``impl`` "auto" or "direct").  Where
    the JAX package takes its blocked panel kernel (``impl="panel"`` above
    128, any dim above 192) or the panel-Schur solve (``impl="schur"``
    above 128), this raises ``NotImplementedError``: that kernel
    (``_gj_panel_kernel``) is not ported yet."""
    n = A.shape[0]
    if A.dtype == torch.float64:
        return _lu_solve_lanes(A, b)
    if n <= XLA_GJ_MAX_DIM:
        return equilibrated_lanes(gj_solve_lanes_ref)(A, b)
    if n > MAX_KERNEL_DIM or (n > SCHUR_MIN_DIM and impl in ("panel",
                                                               "schur")):
        raise NotImplementedError(
            f"dim-{n} solves with impl={impl!r} need the blocked panel "
            "kernel (_gj_panel_kernel, hpfx/ops/batched_solve.py:452), "
            "which is not ported yet")
    return equilibrated_lanes(_kernel_solve)(A, b)
