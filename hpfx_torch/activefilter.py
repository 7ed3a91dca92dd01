"""Active (shunt) harmonic filter sizing (the port of
:mod:`hpfx.activefilter`).

An active shunt filter is a converter at a bus that injects the
antiphase harmonic current, so the bus voltage distortion collapses.
Sizing one is an inverse problem on the solved state: find the injection
spectrum ``I_c(h)`` whose network response cancels the targeted harmonic
voltages.  The coupled device Nortons feed an injection at one order back
into every other, so the sizer runs the Levenberg-Marquardt engine of
:func:`hpfx_torch.estimate._lm_fit` on a COMPLEX voltage residual: the
targeted phasors are ``residual``·V_h at the base phase (a complex target
keeps the fit nearly linear; the magnitude-only form stalls).  Driving
V_h to exactly zero is polar-singular, so the target keeps ``residual``
(default 5%) of it.  Validation is a real re-solve with the fitted
``I_bg``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .estimate import _ift_residuals, _lm_fit
from .harmonic import (harmonic_mismatch, hpf, update_harmonic_voltages)
from .network import Network
from .results import get_thd
from .ybus import build_ybus

__all__ = ["ActiveFilterSizing", "size_active_filter"]


class ActiveFilterSizing(NamedTuple):
    """``I_c``: (H,) compensating spectrum at the bus — (n_b, H) and
    per-bus ``rating_rms``/``thd_*`` arrays when a bus LIST was sized
    (I_bg sign convention: positive injects INTO the bus; zeros at
    uncompensated orders).  ``I_bg``: the (H, n) injections ready for
    ``hpf(..., I_bg=...)``.  ``rating_rms``: sqrt(Σ_h |I_c,h|²) [pu].
    ``thd_before``/``thd_after``: THD_F at the compensated bus.
    ``result``: the validating HPF solve WITH the compensator active.
    ``misfit``/``n_solves``: the LM fit's terminal misfit and solve
    count."""
    I_c: Cx
    I_bg: Cx
    rating_rms: object
    thd_before: object
    thd_after: object
    result: object
    misfit: float
    n_solves: int


def size_active_filter(net: Network, devices, settings: Settings,
                       bus, *, orders: Optional[Sequence] = None,
                       residual: float = 0.05, steps: int = 20,
                       bound: float = 100.0, V0=None,
                       tol: float = 1e-12) -> ActiveFilterSizing:
    """Size a shunt active filter at ``bus`` (an int, or a list of buses
    for a co-sized bank: one LM fit over every compensator's spectrum,
    each bus targeting its own voltage), collapsing every targeted
    harmonic voltage to ``residual``·V_h at the base phase
    (``hpfx.activefilter.size_active_filter``).

    ``orders``: harmonic orders to compensate (default: every solved order
    above the fundamental).  ``steps``/``bound``/``tol`` feed the LM
    loop (``bound`` clips each re/im component of the spectrum, pu).
    """
    rd, dv = settings.real_dtype, net.device
    hs = [int(h) for h in settings.harmonics]
    H, n, m, c = len(hs), net.n, net.m, net.c
    single = np.isscalar(bus) or isinstance(bus, (int, np.integer))
    buses = [int(bus)] if single else [int(b) for b in bus]
    for b in buses:
        if not 0 <= b < n:
            raise ValueError(f"bus {b} out of range (n={n})")
    if len(set(buses)) != len(buses):
        raise ValueError(f"duplicate buses in {buses}")
    if orders is None:
        orders = tuple(hs[1:])
    orders = tuple(int(o) for o in orders)
    for o in orders:
        if o == 1 or o not in hs:
            raise ValueError(f"order {o} not compensatable (fundamental "
                             f"or outside the harmonic grid)")
    k_list = [hs.index(o) for o in orders]
    k_idx = torch.tensor(k_list, device=dv)
    nb = len(buses)
    bus_j = torch.tensor(buses, device=dv)

    base = hpf(net, devices, settings, V0=V0)
    if not bool(base.converged):
        raise RuntimeError("base HPF does not converge — nothing to size "
                           "against")
    thd0 = get_thd(base.V_m).THD_F.cpu().numpy()[buses]       # (nb,)

    # complex target: the base phasors scaled at the compensated rows
    Vb = cx.polar(base.V_m[:, bus_j], base.V_a[:, bus_j])      # (H, nb)
    tgt = Cx(Vb.re[k_idx] * float(residual),
             Vb.im[k_idx] * float(residual))                   # (K, nb)
    at = (k_idx[None, :], bus_j[:, None])

    def make_ibg(th):                                          # (nb, K, 2)
        # out of place and ordered (Cx.at_add): th carries torch.func's
        # dual numbers in jacfwd
        return cx.zeros((H, n), rd, dv).at_add(at, Cx(th[..., 0],
                                                      th[..., 1]))

    def project(th):
        return torch.clamp(th, -float(bound), float(bound))

    theta = torch.zeros((nb, len(orders), 2), dtype=rd, device=dv)

    def solve(th, V0_):
        return hpf(net, devices, settings, V0=V0_, I_bg=make_ibg(th))

    def solve_cold(th):
        return hpf(net, devices, settings, V0=V0, I_bg=make_ibg(th))

    def rj_at(th, res):
        V_m, V_a = res.V_m, res.V_a
        Y = build_ybus(net, settings)
        S = Cx(net.bus_P, net.bus_Q)

        def f(t):
            return harmonic_mismatch(V_m, V_a, Y, S, devices, m, n, c,
                                     I_bg=make_ibg(t))[0]

        def r_of_x(x):
            Vm2, Va2 = update_harmonic_voltages(V_m, V_a, x, H, n, c)
            V = cx.polar(Vm2[:, bus_j][k_idx], Va2[:, bus_j][k_idx])
            return torch.cat([(V.re - tgt.re).ravel(),
                              (V.im - tgt.im).ravel()])

        return _ift_residuals(f, th, V_m, V_a, Y, devices, net, settings,
                              r_of_x)

    fit = _lm_fit(theta, project, solve, solve_cold, rj_at,
                  steps=steps, lm_lambda0=1e-3, tol=tol)

    th = fit.scales.cpu().numpy()                              # (nb, K, 2)
    i_c = np.zeros((nb, H), complex)
    i_c[:, k_list] = th[:, :, 0] + 1j * th[:, :, 1]
    I_c = cx.from_numpy(i_c[0] if single else i_c, rd, dv)
    bg = np.zeros((H, n), complex)
    for j, b in enumerate(buses):
        bg[:, b] += i_c[j]
    I_bg = cx.from_numpy(bg, rd, dv)
    res = hpf(net, devices, settings, V0=V0, I_bg=I_bg)
    thd1 = get_thd(res.V_m).THD_F.cpu().numpy()[buses]
    rating = np.sqrt((np.abs(i_c) ** 2).sum(axis=1))
    return ActiveFilterSizing(
        I_c=I_c, I_bg=I_bg,
        rating_rms=float(rating[0]) if single else rating,
        thd_before=float(thd0[0]) if single else thd0,
        thd_after=float(thd1[0]) if single else thd1,
        result=res, misfit=float(fit.misfit),
        n_solves=int(fit.n_solves))
