"""Harmonic source estimation: fit device injection levels to measured
bus-voltage spectra (the port of :mod:`hpfx.estimate`).

Power-quality meters record |V(h)| at a few buses; the question is which
converters run at what level.  Every solve is differentiable, so the
inverse problem is damped Gauss-Newton (Levenberg-Marquardt) on the exact
residual Jacobian: the implicit function theorem gives dx*/dθ (the column
solve of :mod:`hpfx_torch.sensitivity`), chain-ruled onto the
per-measurement residuals

    r(θ)[h, b] = |V(h, b; θ)| − |V_meas(h, b)|,  b in observed,

so each LM iteration costs one HPF solve and one (dim, n_θ) column solve.
Passing a :class:`hpfx_torch.devices.DeviceLibrary` instead of a DeviceSet
fits the full (n_nl, T) device-mix weights.

∂f/∂θ and the state → residual map are ``torch.func.jacfwd`` of plain
tensor code; the column solve runs outside any transform, so float32
solves reach the card's kernels.  The LM loop stays on the host, as in the
JAX package: its normal equations are solved with numpy.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import Settings
from .cx import Cx
from .devices import DeviceLibrary
from .harmonic import (harmonic_mismatch, harmonic_state_vector, hpf,
                       update_harmonic_voltages)
from .network import Network
from .sensitivity import _solve_columns
from .ybus import build_ybus

__all__ = ["BackgroundEstimate", "EstimateResult", "estimate_background",
           "estimate_injections"]


def _apply(devices, theta):
    """DeviceSet at the fit parameters: per-device scales for a
    DeviceSet, (n_nl, T) mix weights for a DeviceLibrary."""
    if isinstance(devices, DeviceLibrary):
        return devices.mixed(theta)
    return devices.scale(theta)


class EstimateResult(NamedTuple):
    """Outcome of :func:`estimate_injections`.

    ``scales``: (n_nl,) fitted per-device injection scales (a tensor).
    ``misfit``/``misfit0``: sum-of-squares measurement residual at the fit
    / at the start.  ``history``: misfit after each accepted LM step (NaN =
    rejected/diverged proposal).  ``result``: the HPFResult at the fitted
    scales.
    """
    scales: torch.Tensor
    misfit: float
    misfit0: float
    history: np.ndarray
    n_solves: int
    result: object


def _ift_residuals(f, theta, V_m, V_a, Y, dev_t, net: Network,
                   settings: Settings, r_of_x):
    """(r, J): the residuals ``r_of_x(x*)`` at the converged point (V_m,
    V_a) and their Jacobian with respect to ``theta``'s entries,
    J = dR/dx · dx*/dθ with dx*/dθ = −J_f⁻¹·∂f/∂θ; ``f(θ)`` the mismatch
    at the solution, ``dev_t`` the devices J_f is built with."""
    x_star = harmonic_state_vector(V_m, V_a, net.c)
    dim = x_star.shape[0]
    cols = torch.func.jacfwd(f)(theta).reshape(dim, -1)   # (dim, n_theta)
    dx_cols = -_solve_columns(V_m[None], V_a[None], Y, dev_t, net, settings,
                              cols[None])[0]
    r = r_of_x(x_star)
    J = torch.func.jacfwd(r_of_x)(x_star) @ dx_cols       # (R, n_theta)
    return r, J


def _residuals_and_jac(net, devices, settings, V_m, V_a, V_meas, obs,
                       theta, w):
    """(r, J): per-measurement residuals and their exact Jacobian with
    respect to the per-device scales (or mix weights), at the converged
    operating point (V_m, V_a)."""
    H, n, c, m = settings.n_harmonics, net.n, net.c, net.m
    Y = build_ybus(net, settings)
    S = Cx(net.bus_P, net.bus_Q)

    def f(th):
        return harmonic_mismatch(V_m, V_a, Y, S, _apply(devices, th),
                                 m, n, c)[0]

    def r_of_x(x):
        Vm2, _ = update_harmonic_voltages(V_m, V_a, x, H, n, c)
        return (w * (Vm2[:, obs] - V_meas)).ravel()

    return _ift_residuals(f, theta, V_m, V_a, Y, _apply(devices, theta),
                          net, settings, r_of_x)


def _measurements(net: Network, settings: Settings, V_meas_m, buses,
                  weights, p_scale, q_scale):
    """The net at the known load level, the observed bus indices, the
    observed measurements and their weights, on the net's device."""
    rd, dv = settings.real_dtype, net.device
    t = lambda x: torch.as_tensor(x, dtype=rd, device=dv)
    # the (known) load level applies to the solves AND the mismatch the
    # Jacobian differentiates (both see the same scaled net)
    net = dataclasses.replace(net, bus_P=net.bus_P * t(p_scale),
                              bus_Q=net.bus_Q * t(q_scale))
    obs = (torch.arange(net.n, device=dv) if buses is None
           else torch.as_tensor(list(buses), dtype=torch.long, device=dv))
    if not isinstance(V_meas_m, torch.Tensor):
        V_meas_m = np.array(V_meas_m)                 # a writable copy
    V_meas = torch.as_tensor(V_meas_m, dtype=rd, device=dv)[:, obs]
    if weights is None:
        w = torch.ones_like(V_meas)
    elif isinstance(weights, str) and weights == "relative":
        w = 1.0 / torch.clamp_min(V_meas, 1e-6)
    else:
        w = t(weights)
    return net, obs, V_meas, w


def estimate_injections(
    net: Network, devices, settings: Settings, V_meas_m, *,
    buses: Optional[Sequence[int]] = None,
    scales0=1.0, steps: int = 25, bounds=(0.0, 3.0),
    p_scale=1.0, q_scale=1.0, weights=None,
    lm_lambda0: float = 1e-3, tol: float = 1e-9,
) -> EstimateResult:
    """Fit per-device injection scales to measured |V(h)| spectra by
    Levenberg-Marquardt on the exact IFT residual Jacobian
    (``hpfx.estimate.estimate_injections``).

    ``V_meas_m``: (H, n) measured voltage magnitudes on the settings'
    harmonic grid (a tensor or numpy array); only rows of ``buses``
    (default: all buses) enter the misfit.  ``weights``: ``None``
    (absolute residuals), ``"relative"`` (each residual scaled by
    1/|V_meas|) or an explicit (H, n_observed) array.  ``scales0``: scalar
    or (n_nl,) starting guess.  ``p_scale``/``q_scale``: the (known) load
    level the measurements were taken at.  ``steps``: max LM iterations;
    the loop stops early when a step improves the misfit by less than
    ``tol`` relative to its value.  Proposals are projected onto
    ``bounds`` and must converge (warm-started solve, cold retry).
    """
    rd = settings.real_dtype
    n_nl = net.n_nonlinear
    shape = ((n_nl, devices.n_types)
             if isinstance(devices, DeviceLibrary) else (n_nl,))
    net, obs, V_meas, w = _measurements(net, settings, V_meas_m, buses,
                                        weights, p_scale, q_scale)

    def project(th):
        return torch.clamp(th, *bounds)

    theta = project(torch.broadcast_to(
        torch.as_tensor(scales0, dtype=rd, device=net.device), shape))

    def solve(th, V0):
        return hpf(net, _apply(devices, th), settings, V0=V0)

    def solve_cold(th):
        return hpf(net, _apply(devices, th), settings)

    def rj_at(th, res):
        return _residuals_and_jac(net, devices, settings,
                                  res.V_m, res.V_a, V_meas, obs, th, w)

    return _lm_fit(theta, project, solve, solve_cold, rj_at,
                   steps=steps, lm_lambda0=lm_lambda0, tol=tol)


def _lm_fit(theta, project, solve, solve_cold, rj_at, *,
            steps: int, lm_lambda0: float, tol: float) -> EstimateResult:
    """The damped Gauss-Newton loop shared by the estimators
    (``hpfx.estimate._lm_fit``).

    ``solve(th, V0)``/``solve_cold(th)``: HPF at parameters ``th``;
    ``rj_at(th, res)``: (residuals, Jacobian with respect to th's entries)
    at the converged point.  Proposals are projected, must converge (warm
    then cold retry), and must improve the misfit; rejected proposals
    raise the damping.
    """
    res = solve_cold(theta)
    if not bool(res.converged):
        raise RuntimeError("HPF does not converge at the starting "
                           "parameters")
    n_solves = 1
    r, J = rj_at(theta, res)
    misfit = misfit0 = float(r @ r)
    history = []
    lam = lm_lambda0

    for _ in range(steps):
        Jn, rn = J.cpu().numpy(), r.cpu().numpy()
        JtJ, Jtr = Jn.T @ Jn, Jn.T @ rn
        accepted = False
        for _try in range(8):
            step = np.linalg.solve(
                JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-12)),
                -Jtr)
            proposal = project(theta + torch.as_tensor(
                step, dtype=theta.dtype,
                device=theta.device).reshape(theta.shape))
            cand = solve(proposal, (res.V_m, res.V_a))
            n_solves += 1
            if not bool(cand.converged):
                cand = solve_cold(proposal)
                n_solves += 1
            if bool(cand.converged):
                r_c, J_c = rj_at(proposal, cand)
                m_c = float(r_c @ r_c)
                if m_c < misfit:
                    theta, res, r, J = proposal, cand, r_c, J_c
                    improved = misfit - m_c
                    misfit = m_c
                    lam = max(lam / 3.0, 1e-12)
                    accepted = True
                    break
            lam *= 10.0
        history.append(misfit if accepted else float("nan"))
        if not accepted or improved < tol * misfit + 1e-300:
            break

    return EstimateResult(
        scales=theta, misfit=misfit, misfit0=misfit0,
        history=np.asarray(history, dtype=np.float64),
        n_solves=n_solves, result=res)


class BackgroundEstimate(NamedTuple):
    """Outcome of :func:`estimate_background`.

    ``v_bg``: (n_orders,) fitted complex background Thevenin voltages
    (numpy complex; injected Norton currents with ``as_current=True``).
    ``orders``: the fitted harmonic orders.  The rest as
    :class:`EstimateResult`.
    """
    v_bg: np.ndarray
    orders: tuple
    misfit: float
    misfit0: float
    history: np.ndarray
    n_solves: int
    result: object


def estimate_background(
    net: Network, devices, settings: Settings, V_meas_m, *,
    orders: Sequence[int], bus: int = 0,
    buses: Optional[Sequence[int]] = None,
    steps: int = 25, bound: float = 0.2,
    p_scale=1.0, q_scale=1.0, weights=None,
    lm_lambda0: float = 1e-3, tol: float = 1e-9,
    as_current: bool = False,
) -> BackgroundEstimate:
    """Fit the upstream background spectrum to measured |V(h)|
    (``hpfx.estimate.estimate_background``): complex Thevenin voltages
    V_bg(h) at ``orders`` behind ``bus``'s X_sh (injected Norton currents
    with ``as_current=True``), parametrized by their re/im parts, so the
    Norton term is linear in them.  Same LM loop, observability and
    weighting as :func:`estimate_injections`; ``bound`` clips each re/im
    component to [-bound, bound] pu.
    """
    from .background import shunt_admittance

    rd = settings.real_dtype
    dv = net.device
    H, n, c, m = settings.n_harmonics, net.n, net.c, net.m
    grid = [int(h) for h in settings.harmonics]
    orders = tuple(int(h) for h in orders)
    for h in orders:
        if h == 1 or h not in grid:
            raise ValueError(f"order {h} not fittable (fundamental or "
                             f"outside the harmonic grid, max {grid[-1]})")
    k_idx = torch.tensor([grid.index(h) for h in orders], device=dv)

    if as_current:
        conv = Cx(torch.ones(H, dtype=rd, device=dv),
                  torch.zeros(H, dtype=rd, device=dv))      # identity
    else:
        conv = shunt_admittance(net, settings, bus)         # (H,) Cx
    e_bus = (torch.arange(n, device=dv) == bus).to(rd)

    def make_ibg(th):
        # out of place: th carries torch.func's dual numbers in jacfwd
        z = torch.zeros(H, dtype=rd, device=dv)
        v = Cx(z.index_put((k_idx,), th[:, 0]),
               z.index_put((k_idx,), th[:, 1]))
        i = v * conv                                        # (H,) Norton
        return Cx(i.re[:, None] * e_bus, i.im[:, None] * e_bus)

    net, obs, V_meas, w = _measurements(net, settings, V_meas_m, buses,
                                        weights, p_scale, q_scale)

    def project(th):
        return torch.clamp(th, -bound, bound)

    theta = torch.zeros((len(orders), 2), dtype=rd, device=dv)

    def solve(th, V0):
        return hpf(net, devices, settings, V0=V0, I_bg=make_ibg(th))

    def solve_cold(th):
        return hpf(net, devices, settings, I_bg=make_ibg(th))

    def rj_at(th, res):
        V_m, V_a = res.V_m, res.V_a
        Y = build_ybus(net, settings)
        S = Cx(net.bus_P, net.bus_Q)

        def f(t):
            return harmonic_mismatch(V_m, V_a, Y, S, devices, m, n, c,
                                     I_bg=make_ibg(t))[0]

        def r_of_x(x):
            Vm2, _ = update_harmonic_voltages(V_m, V_a, x, H, n, c)
            return (w * (Vm2[:, obs] - V_meas)).ravel()

        return _ift_residuals(f, th, V_m, V_a, Y, devices, net, settings,
                              r_of_x)

    fit = _lm_fit(theta, project, solve, solve_cold, rj_at,
                  steps=steps, lm_lambda0=lm_lambda0, tol=tol)
    th = fit.scales.cpu().numpy()
    return BackgroundEstimate(
        v_bg=th[:, 0] + 1j * th[:, 1], orders=orders,
        misfit=fit.misfit, misfit0=fit.misfit0, history=fit.history,
        n_solves=fit.n_solves, result=fit.result)
