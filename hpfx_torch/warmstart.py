"""Exact-linear Norton warm starts (``hpfx.warmstart``).

At a solved fundamental, the harmonic current balance is linear in the
harmonic voltages in rectangular coordinates: the network gives Y_h·V_h
and every Norton device I_N − Y_N·V, cross-harmonic coupling included.
One (H−1)·n complex block system per scenario therefore lands Newton on
the exact harmonic solution given the fundamental:

    Σ_p [δ_hp·Y_h − E·diag_d(Y_N[d,h,p])·Eᵀ] V_p
        = −E·I_N[:,h] + E·(Y_N[:,h,0] ⊙ V₁,nl) − I_bg[h]

with E the scatter of device d onto bus m + d and h, p ≥ 1.
:func:`norton_warm_start` solves it batch-major for a sweep's scenarios
(through :func:`hpfx_torch.cx.solve`, ``torch.linalg.solve``, as the JAX
package takes ``jnp.linalg.solve``); the lane-major sweeps seed in place
(``hpfx_torch.lanes._linear_seed_lanes``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import cx
from .config import Settings
from .cx import Cx
from .devices import DeviceSet
from .fundamental import solve_fundamental
from .network import Network
from .ybus import resolve_ybus

__all__ = ["harmonic_linear_seed", "norton_warm_start"]


def _floor_seed_mag(V_m_h, settings: Settings):
    """Lift seeded harmonic magnitudes that solved to exact zero (a
    harmonic order with no source) away from the polar singularity, where
    the angle-Jacobian column vanishes; sourced magnitudes are untouched."""
    eps = torch.full_like(V_m_h, 1e-2 * settings.v_init_h)
    return torch.where(V_m_h < 1e-20, eps, V_m_h)


def harmonic_linear_seed(Y: Cx, net: Network, settings: Settings,
                         devices: DeviceSet, V1: Cx,
                         I_bg: Optional[Cx] = None) -> Cx:
    """The (..., H−1, n) harmonic voltages that zero the harmonic
    current-balance rows at the fundamental phasors ``V1`` (..., n)
    (``hpfx.warmstart.harmonic_linear_seed``).  ``devices``: the
    scenario-scaled DeviceSet, with the same leading axes as ``V1``;
    ``I_bg``: optional (..., H, n) background injections."""
    H, n, m = settings.n_harmonics, net.n, net.m
    K = H - 1
    rd, dv = settings.real_dtype, V1.device
    batch = V1.shape[:-1]
    eyeK = torch.eye(K, dtype=rd, device=dv)
    eyeN = torch.eye(n, dtype=rd, device=dv)
    blockdiag = Y[1:][:, :, None, :] * eyeK[:, None, :, None]  # (h, i, p, j)

    # the device coupling on the bus diagonal: D[..., h, p, i] holds
    # Y_N[i − m, h + 1, p + 1] on the nonlinear buses
    def coupling(YN):
        D = torch.zeros(batch + (K, K, n), dtype=rd, device=dv)
        if devices.coupled:
            D[..., m:] = YN[..., 1:, 1:].movedim(-3, -1)
        else:
            i = torch.arange(K, device=dv)
            D[..., i, i, m:] = YN[..., 1:].mT
        # term[..., h, i, p, j] = δ_ij · D[..., h, p, i]
        return D.transpose(-2, -1)[..., None] * eyeN[:, None, :]

    N = K * n
    A = Cx((blockdiag.re - coupling(devices.Y_N.re)).reshape(batch + (N, N)),
           (blockdiag.im - coupling(devices.Y_N.im)).reshape(batch + (N, N)))

    rhs = cx.zeros(batch + (K, n), rd, dv)
    nl = (..., slice(None), slice(m, None))
    rhs = rhs.at_add(nl, -(devices.I_N[..., 1:].mT))
    if devices.coupled:
        # the p = 0 (fundamental) coupling column moves to the right
        fold = devices.Y_N[..., 1:, 0] * V1[..., m:, None]    # (..., n_nl, K)
        rhs = rhs.at_add(nl, fold.mT)
    if I_bg is not None:
        rhs = rhs - I_bg[..., 1:, :]
    return cx.solve(A, rhs.reshape(batch + (N,))).reshape(batch + (K, n))


def norton_warm_start(net: Network, devices: DeviceSet, settings: Settings,
                      scenarios, Y=None, I_bg: Optional[Cx] = None):
    """Batched exact-linear harmonic seed (``hpfx.warmstart``): pass as
    ``V0`` to ``hpf_sweep``/``hpf_sweep_adaptive``.  Returns batch-major
    ``(V_m, V_a)`` (B, H, n).

    The batched fundamental PF at the sweep's own scaling, then one
    coupled-linear harmonic solve per scenario, chunked over the
    scenarios so that the float64-embedded matrices of a chunk stay
    within ``lanes.SEED_CHUNK_BYTES``: 8·(K·n)² bytes a scenario at the
    real dtype's size, the JAX package's rule, so the chunks are the
    same.  ``Y`` as in the sweeps; ``I_bg``: one (H, n) background shared
    by every scenario.  ``device_mix`` scenarios are refused (pre-mix the
    library), as are devices other than a DeviceSet."""
    from . import lanes
    if not isinstance(devices, DeviceSet):
        raise TypeError(
            "norton_warm_start expects a DeviceSet; for analytic "
            "constant-current devices start cold or pass V0")
    if getattr(scenarios, "device_mix", None) is not None:
        raise ValueError("norton_warm_start does not support device_mix "
                         "scenarios — pre-mix the DeviceLibrary instead")
    Yd, _, lineY_f = resolve_ybus(net, settings, Y)
    rd = settings.real_dtype
    p = scenarios.p_scale
    q = scenarios.q_scale if scenarios.q_scale is not None else p
    inj = scenarios.injection_scale
    if inj is None:
        inj = torch.ones_like(p)
    col = lambda x: (x[:, None] if x.dim() == 1 else x).to(rd)
    net_s = dataclasses.replace(net, bus_P=net.bus_P * col(p),
                                bus_Q=net.bus_Q * col(q))
    fund = solve_fundamental(Yd[0], net_s, settings, lineY=lineY_f)
    dev_s = devices.scale(col(inj))
    V1 = cx.polar(fund.V_m, fund.V_a)                     # (B, n)

    B = p.shape[0]
    Kn = (settings.n_harmonics - 1) * net.n
    per = 8 * Kn * Kn * (torch.finfo(rd).bits // 8)
    chunk = int(max(1, min(B, lanes.SEED_CHUNK_BYTES // per)))
    parts = []
    for lo in range(0, B, chunk):
        sl = slice(lo, min(lo + chunk, B))
        dev_c = dataclasses.replace(dev_s, I_N=dev_s.I_N[sl],
                                    Y_N=dev_s.Y_N[sl])
        parts.append(harmonic_linear_seed(Yd, net, settings, dev_c, V1[sl],
                                          I_bg=I_bg))
    Vh = cx.concatenate(parts, axis=0)                    # (B, K, n)
    V_m = torch.cat([fund.V_m[:, None],
                     _floor_seed_mag(Vh.abs(), settings)], dim=1)
    V_a = torch.cat([fund.V_a[:, None], Vh.angle()], dim=1)
    return V_m, V_a
