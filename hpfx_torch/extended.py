"""Devices with internal control unknowns: the extended-Jacobian HPF (the
port of :mod:`hpfx.extended`).

A :class:`ControlledDeviceSet` carries, per nonlinear bus, ``n_u``
internal unknowns ``u`` (firing angles, DC-link states, ...), an
injection ``inject(params_i, V_m (H,), V_a (H,), u (n_u,)) -> Cx (H,)``
and ``n_u`` real closure equations ``constraint(params_i, V_m, V_a, u) ->
(n_u,)``, both torch functions.  :func:`solve_harmonic_extended` solves
the network state and the unknowns together by Newton-Raphson on
``[f(V, u); g(V, u)]``, the Jacobian by ``torch.func.jacfwd`` of the whole
residual and the step by ``torch.linalg.solve``.  Textbook-scale systems:
one host sync a Newton iteration.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .config import Settings
from .cx import Cx
from .devices import AnalyticDeviceSet
from .fundamental import FundResult, solve_fundamental
from .harmonic import (cleanup_voltages, harmonic_mismatch,
                       harmonic_state_vector, init_harmonic_voltages,
                       mismatch_floor, update_harmonic_voltages)
from .network import Network
from .ybus import build_ybus


@dataclasses.dataclass(frozen=True)
class ControlledDeviceSet:
    """Nonlinear devices with ``n_u`` internal Newton unknowns each:
    ``params`` (a nested tuple of tensors or ``Cx`` with a leading n_nl
    axis), ``u0`` (n_nl, n_u) initial unknowns, and the per-device torch
    functions ``inject`` and ``constraint``."""

    params: object
    u0: torch.Tensor                      # (n_nl, n_u) initial unknowns
    inject: object
    constraint: object
    n_nl: int
    n_u: int

    coupled = True

    def at_u(self, u) -> AnalyticDeviceSet:
        """The devices with the unknowns frozen at ``u``: an analytic
        device the standard mismatch takes."""
        inject = self.inject

        def inject_u(params_u, V_m, V_a):
            p, ui = params_u
            return inject(p, V_m, V_a, ui)

        return AnalyticDeviceSet(params=(self.params, u), inject=inject_u,
                                 n_nl=self.n_nl)


class ExtendedResult(NamedTuple):
    V_m: torch.Tensor          # (H, n)
    V_a: torch.Tensor
    u: torch.Tensor            # (n_nl, n_u) solved device unknowns
    err: torch.Tensor
    n_iter: torch.Tensor
    err_hist: torch.Tensor
    converged: torch.Tensor
    fund: Optional[FundResult] = None


def solve_harmonic_extended(Y: Cx, fund: FundResult, net: Network,
                            devices: ControlledDeviceSet,
                            settings: Settings) -> ExtendedResult:
    """Coupled Newton over [network state; device unknowns]: the residual
    is the harmonic mismatch at frozen ``u`` followed by the device
    constraints (``torch.func.vmap`` over the devices), the Jacobian its
    ``torch.func.jacfwd``; the floor-aware threshold as in the plain
    solver, at the start."""
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    S = Cx(net.bus_P, net.bus_Q)
    V_m0, V_a0 = init_harmonic_voltages(fund, net, settings)
    nx = 2 * H * n - 1 - c
    constraints = torch.func.vmap(devices.constraint, in_dims=(0, 1, 1, 0))

    def residual(x_ext):
        x, u = x_ext[:nx], x_ext[nx:].reshape(devices.n_nl, devices.n_u)
        V_m, V_a = update_harmonic_voltages(V_m0, V_a0, x, H, n, c)
        f, _ = harmonic_mismatch(V_m, V_a, Y, S, devices.at_u(u), m, n, c)
        g = constraints(devices.params, V_m[:, m:], V_a[:, m:], u)
        return torch.cat([f, g.reshape(-1)])

    x_ext = torch.cat([harmonic_state_vector(V_m0, V_a0, c),
                       devices.u0.reshape(-1).to(V_m0.dtype)])
    f = residual(x_ext)
    err = f.abs().max()
    thresh = torch.clamp_min(
        settings.floor_kappa * mismatch_floor(
            V_m0, Y, devices.at_u(devices.u0), m, settings),
        settings.thresh_h)
    hist = torch.full((settings.max_iter_h,), float("nan"),
                      dtype=settings.real_dtype, device=net.device)
    it = 0
    while bool(err > thresh) and it < settings.max_iter_h:
        J = torch.func.jacfwd(residual)(x_ext)
        x_ext = x_ext - torch.linalg.solve(J, f)
        f = residual(x_ext)
        err = f.abs().max()
        hist[it] = err
        it += 1

    x, u = x_ext[:nx], x_ext[nx:].reshape(devices.n_nl, devices.n_u)
    V_m, V_a = update_harmonic_voltages(V_m0, V_a0, x, H, n, c)
    V_m, V_a = cleanup_voltages(V_m, V_a)
    return ExtendedResult(V_m, V_a, u, err,
                          torch.tensor(it, dtype=torch.int32,
                                       device=net.device),
                          hist, err <= thresh, fund)


def hpf_extended(net: Network, devices: ControlledDeviceSet,
                 settings: Settings) -> ExtendedResult:
    """Admittances, the fundamental solve, then the extended harmonic
    Newton (``hpfx.extended.hpf_extended``)."""
    Y = build_ybus(net, settings)
    fund = solve_fundamental(Y[0], net, settings)
    return solve_harmonic_extended(Y, fund, net, devices, settings)
