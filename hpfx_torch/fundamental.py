"""Fundamental-frequency Newton-Raphson power flow: the port of
:mod:`hpfx.fundamental`.

State layout as in the reference: ``x = [V_a[1:], V_m[c:]]``; mismatch
``V∘conj(Y1·V) + S`` with S > 0 for loads.  Every function takes leading
scenario axes: a single case has none, a batch-major sweep
(``hpfx_torch.solve.hpf_sweep``, layout "vmap") one.  The batched
fundamental solve of the lane-major sweep is
``hpfx_torch.lanes.solve_fundamental_lanes``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network
from .ops.batched_solve import nr_solve


class FundResult(NamedTuple):
    V_m: torch.Tensor       # (n,) or batch-major (B, n)
    V_a: torch.Tensor
    err: torch.Tensor       # final max-abs mismatch
    n_iter: torch.Tensor
    err_hist: torch.Tensor  # (max_iter_f,), NaN-padded
    converged: torch.Tensor


def fund_mismatch(V_m, V_a, Y1: Cx, S: Cx, c: int, lineY=None):
    """Power mismatch f = [Re(mis)[1:], Im(mis)[c:]] with
    mis = V∘conj(Y1·V) + S, and its max-abs err.  ``lineY``: optional
    fundamental-sliced ``LineYbus`` for the cancellation-free Y·V."""
    V = cx.polar(V_m, V_a)
    if lineY is None:
        I = cx.matvec(Y1, V)
    else:
        from .ybus import stable_matvec
        I = stable_matvec(lineY, V_m[..., None, :], V_a[..., None, :])
        I = I[..., 0, :]
    mis = V * I.conj() + S
    f = torch.cat([mis.re[..., 1:], mis.im[..., c:]], dim=-1)
    return f, f.abs().amax(dim=-1)


def _power_jacobian_blocks(V: Cx, Vn: Cx, Y: Cx, n: int):
    """dS/dA and dS/dV as (..., n, n) split-complex matrices:
    dS/dA[i,j] = j·V_i·conj(δ_ij·I_i − Y_ij·V_j),
    dS/dV[i,j] = δ_ij·Vn_i·conj(I_i) + V_i·conj(Y_ij·Vn_j), I = Y·V."""
    I = cx.matvec(Y, V)
    eye = torch.eye(n, dtype=V.dtype, device=V.device)
    diag_I = Cx(eye * I.re[..., :, None], eye * I.im[..., :, None])
    col = lambda z: Cx(z.re[..., :, None], z.im[..., :, None])
    row = lambda z: Cx(z.re[..., None, :], z.im[..., None, :])
    dSdA = (col(V) * (diag_I - Y * row(V)).conj()).jmul()
    w = Vn * I.conj()
    diag_w = Cx(eye * w.re[..., :, None], eye * w.im[..., :, None])
    dSdV = diag_w + col(V) * (Y * row(Vn)).conj()
    return dSdA, dSdV


def fund_jacobian(V_m, V_a, Y1: Cx, n: int, c: int):
    """Dense real fundamental Jacobian (..., 2n-1-c, 2n-1-c):
    [[Re dSdA[1:,1:], Re dSdV[1:,c:]], [Im dSdA[c:,1:], Im dSdV[c:,c:]]]."""
    V = cx.polar(V_m, V_a)
    Vn = V * (1.0 / V.abs())        # |V| normalization
    dSdA, dSdV = _power_jacobian_blocks(V, Vn, Y1, n)
    top = torch.cat([dSdA.re[..., 1:, 1:], dSdV.re[..., 1:, c:]], dim=-1)
    bot = torch.cat([dSdA.im[..., c:, 1:], dSdV.im[..., c:, c:]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def init_fund_voltages(net: Network, settings: Settings):
    """Flat start, one (n,) row per scenario of ``net.bus_P``'s leading
    axes."""
    rd, shape = settings.real_dtype, net.bus_P.shape
    V_m = torch.full(shape, settings.v_init_f, dtype=rd, device=net.device)
    V_a = torch.full(shape, settings.a_init_f, dtype=rd, device=net.device)
    return V_m, V_a


def solve_fundamental(Y1: Cx, net: Network, settings: Settings,
                      lineY=None) -> FundResult:
    """Fundamental NR loop (``hpfx.fundamental.solve_fundamental``).

    A network whose ``bus_P``/``bus_Q`` carry leading scenario axes is
    solved as a batch, as the JAX package's ``vmap`` solves it: the body
    runs over the whole batch and each scenario's state stops changing
    once its own test fails (``torch.where`` on its active flag); the loop
    ends when none is active, one host synchronisation per iteration.
    The threshold is floor-aware: max(thresh_f, floor_kappa·eps·
    max(|V|·(|Y1|·|V|) + |S|)), the plain thresh_f in float64."""
    n, c = net.n, net.c
    rd, dv = settings.real_dtype, net.device
    S = Cx(net.bus_P, net.bus_Q)
    V_m, V_a = init_fund_voltages(net, settings)
    batch = V_m.shape[:-1]

    x = torch.cat([V_a[..., 1:], V_m[..., c:]], dim=-1)
    f, err = fund_mismatch(V_m, V_a, Y1, S, c, lineY)
    hist = torch.full(batch + (settings.max_iter_f,), float("nan"),
                      dtype=rd, device=dv)

    eps = torch.finfo(rd).eps
    rows = V_m.abs() * torch.einsum(
        "ij,...j->...i" if Y1.ndim == 2 else "...ij,...j->...i",
        Y1.abs(), V_m.abs())
    thresh = torch.clamp_min(
        settings.floor_kappa * eps * (rows + S.abs()).amax(dim=-1),
        settings.thresh_f)

    it = torch.zeros(batch, dtype=torch.int32, device=dv)
    t = 0
    act = (err > thresh) & (it < settings.max_iter_f)
    while bool(act.any()):
        J = fund_jacobian(V_m, V_a, Y1, n, c)
        x_new = x - nr_solve(J, f)
        Va_new = torch.cat([V_a[..., :1], x_new[..., : n - 1]], dim=-1)
        Vm_new = torch.cat([V_m[..., :c], x_new[..., n - 1:]], dim=-1)
        f_new, err_new = fund_mismatch(Vm_new, Va_new, Y1, S, c, lineY)
        a = act[..., None]
        V_m = torch.where(a, Vm_new, V_m)
        V_a = torch.where(a, Va_new, V_a)
        x = torch.where(a, x_new, x)
        f = torch.where(a, f_new, f)
        err = torch.where(act, err_new, err)
        hist[..., t] = torch.where(act, err_new, hist[..., t])
        it = it + act.to(torch.int32)
        t += 1
        act = (err > thresh) & (it < settings.max_iter_f)
    return FundResult(V_m, V_a, err, it, hist, err <= thresh)


def pf(Y: Cx, net: Network, settings: Settings) -> FundResult:
    """:func:`solve_fundamental` on the fundamental block of the (H, n, n)
    admittance tensor."""
    return solve_fundamental(Y[..., 0, :, :], net, settings)
