"""Gradient-based network design on top of the HPF solver (the port of
:mod:`hpfx.optimize`).

Every solve is differentiable (the implicit-function-theorem machinery of
:mod:`hpfx_torch.sensitivity`), so design questions become first-order
optimization: transformer taps and phase shifts, series-impedance
reinforcement (:func:`optimize_line_params`) and tuned shunt filters
(:func:`optimize_filter`).  Each loop runs on the host: solve the coupled
HPF at the current parameters, take the exact IFT gradient of the
objective, update with the optimizer (default
:class:`hpfx_torch.optim.Adam`), project onto the bounds.  The solves and
gradients are plain PyTorch calls on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Settings
from .harmonic import hpf
from .network import Network
from .optim import Adam
from .results import get_thd
from .sensitivity import (FilterParams, LineParams, _filter_Y,
                          filter_sensitivity, line_sensitivity,
                          sweep_filter_sensitivity)
from .ybus import build_ybus

__all__ = ["OptimizeResult", "optimize_line_params", "apply_line_params",
           "FilterOptResult", "optimize_filter"]

#: default box bounds per LineParams leaf (projection after each step)
DEFAULT_BOUNDS = {
    "z_scale": (0.25, 4.0),     # relative to the network as loaded
    "tau": (0.85, 1.15),        # off-nominal tap range
    "shift_rad": (-np.pi / 3, np.pi / 3),
}


def _worst_thd(V_m, V_a):
    return get_thd(V_m).THD_F.amax()


class OptimizeResult(NamedTuple):
    """Outcome of :func:`optimize_line_params`.

    ``params``: the best-found :class:`LineParams` (z_scale relative to
    the INPUT network).  ``net``: the input network with those parameters
    applied.  ``value``/``value0``: objective at the optimum / at the
    start.  ``history``: objective after each step (NaN = the solver did
    not converge there, step rejected).  ``n_solves``: HPF solves spent.
    """
    params: LineParams
    net: Network
    value: float
    value0: float
    history: np.ndarray
    n_solves: int


def apply_line_params(net: Network, params: LineParams) -> Network:
    """The input network with ``params`` applied (z_scale multiplies the
    series R and X; tau/shift replace the per-line transformer values)."""
    t = lambda x: torch.as_tensor(x, dtype=net.line_R.dtype,
                                  device=net.device)
    z = t(params.z_scale)
    return dataclasses.replace(
        net, line_R=net.line_R * z, line_X=net.line_X * z,
        line_tau=t(params.tau), line_shift=t(params.shift_rad))


def _project(params: LineParams, bounds, masks) -> LineParams:
    """Clip each leaf onto its box, but only where the entry is optimized
    (varied leaf AND free line): frozen values are never moved, even if
    they sit outside the box."""
    return LineParams(*(
        torch.where(masks[name] > 0, torch.clamp(leaf, *bounds[name]), leaf)
        for name, leaf in zip(LineParams._fields, params)))


def optimize_line_params(
    net: Network, devices, settings: Settings, *,
    vary: Sequence[str] = ("tau",),
    steps: int = 25,
    learning_rate: float = 0.02,
    optimizer=None,
    bounds: Optional[dict] = None,
    functional: Callable = None,
    fixed_lines: Optional[Sequence[int]] = None,
) -> OptimizeResult:
    """Minimize ``functional(V_m, V_a)`` (default: the worst-bus THD_F)
    over line/transformer parameters
    (``hpfx.optimize.optimize_line_params``).

    ``vary``: which :class:`LineParams` leaves to optimize (``"tau"``,
    ``"shift_rad"``, ``"z_scale"``).  ``fixed_lines``: indices of lines
    whose parameters must not move.  ``bounds``: ``{leaf: (lo, hi)}``
    overrides of ``DEFAULT_BOUNDS``.  ``optimizer``: an object with the
    ``init``/``update`` protocol of :mod:`hpfx_torch.optim` (default
    ``Adam(learning_rate)``).  Steps whose warm-started solve does not
    converge retry cold; if that fails too the step is rejected
    (parameters halved back toward the previous iterate).
    """
    if functional is None:
        functional = _worst_thd
    if optimizer is None:
        optimizer = Adam(learning_rate)
    b = dict(DEFAULT_BOUNDS)
    b.update(bounds or {})
    unknown = set(vary) - set(LineParams._fields)
    if unknown:
        raise ValueError(f"vary contains unknown leaves {sorted(unknown)}; "
                         f"valid: {LineParams._fields}")
    rd, dv = settings.real_dtype, net.device
    L = net.n_lines
    free = torch.ones((L,), dtype=rd, device=dv)
    if fixed_lines is not None:
        free[torch.as_tensor(list(fixed_lines), device=dv)] = 0.0
    masks = {name: free * float(name in vary)
             for name in LineParams._fields}

    # parameters are ABSOLUTE (z relative to the input net): the solve and
    # the gradient are both taken at the applied network, so grad.z_scale
    # is d/d(local scale) at the current point, chain-ruled below onto the
    # absolute z
    params = _project(LineParams(
        z_scale=torch.ones((L,), dtype=rd, device=dv),
        tau=net.line_tau.to(rd), shift_rad=net.line_shift.to(rd)),
        b, masks)

    lp_template = LineParams(z_scale=torch.ones((L,), dtype=rd, device=dv))

    def solve(net_k, V0):
        return hpf(net_k, devices, settings, V0=V0)

    def solve_cold(net_k):
        return hpf(net_k, devices, settings)

    def grad_at(net_k, res):
        sens = line_sensitivity(net_k, devices, settings, res,
                                line_params=lp_template,
                                functional=functional)
        return sens.value, sens.grad

    opt_state = optimizer.init(params)
    res = solve_cold(apply_line_params(net, params))
    if not bool(res.converged):
        raise RuntimeError("HPF does not converge at the initial "
                           "parameters — nothing to optimize from")
    n_solves = 1
    value0, g = grad_at(apply_line_params(net, params), res)
    value0 = float(value0)
    best_params, best_value, best_res = params, value0, res
    history = []

    for _ in range(steps):
        # local z grad -> absolute z grad (R_abs = R0 * z_abs, the local
        # scale multiplies R_abs: df/dz_abs = df/dz_local / z_abs)
        g_abs = LineParams(
            z_scale=(g.z_scale / params.z_scale) * masks["z_scale"],
            tau=g.tau * masks["tau"],
            shift_rad=g.shift_rad * masks["shift_rad"])
        updates, opt_state = optimizer.update(g_abs, opt_state, params)
        proposal = _project(
            LineParams(*(p + u for p, u in zip(params, updates))), b, masks)

        res_new = solve(apply_line_params(net, proposal),
                        (best_res.V_m, best_res.V_a))
        n_solves += 1
        if not bool(res_new.converged):
            res_new = solve_cold(apply_line_params(net, proposal))
            n_solves += 1
        if not bool(res_new.converged):
            # reject: halve back toward the last accepted iterate
            params = LineParams(*(0.5 * (p + q) for p, q
                                  in zip(proposal, params)))
            history.append(float("nan"))
            continue
        params = proposal
        value, g = grad_at(apply_line_params(net, params), res_new)
        value = float(value)
        history.append(value)
        if value < best_value:
            best_params, best_value, best_res = params, value, res_new

    return OptimizeResult(
        params=best_params, net=apply_line_params(net, best_params),
        value=best_value, value0=value0,
        history=np.asarray(history, dtype=np.float64),
        n_solves=n_solves)


DEFAULT_FILTER_BOUNDS = {
    "h_tune": (2.0, None),      # upper bound filled from the harmonic set
    "x_cap": (1e-3, 10.0),
}


class FilterOptResult(NamedTuple):
    """Outcome of :func:`optimize_filter`.  ``Y``: the network admittance
    with the optimized filter installed; solve with ``hpf(..., Y=Y)`` to
    reproduce ``value``."""
    params: object            # FilterParams at the optimum
    Y: object                 # Cx (H, n, n) with the filter installed
    value: float
    value0: float
    history: np.ndarray
    n_solves: int


def optimize_filter(
    net: Network, devices, settings: Settings, bus, *,
    h_tune0: float = None, x_cap0: float = 1.0, quality: float = 30.0,
    steps: int = 25, learning_rate: float = 0.05,
    optimizer=None, bounds: Optional[dict] = None,
    functional: Callable = None,
    scenarios=None, reduce: str = "mean",
    v_limits: Optional[Tuple[float, float]] = (0.5, 2.0),
    v_penalty: float = 100.0,
) -> FilterOptResult:
    """Tune a single-tuned shunt filter at ``bus`` by gradient descent on
    the full coupled HPF (``hpfx.optimize.optimize_filter``): minimize
    ``functional(V_m, V_a)`` (default worst-bus THD_F) over the filter's
    resonant order and capacitor size, with the exact IFT gradients of
    :func:`hpfx_torch.sensitivity.filter_sensitivity`.

    ``h_tune0`` defaults to the worst OPERATIONAL resonance order at
    ``bus`` (the device-inclusive scan).  Every evaluation is a COLD solve
    (warm-tracking can follow a branch a cold energization never
    reaches), and an unacceptable proposal backtracks the STEP, not the
    parameters.  ``scenarios``: tune ONE filter against a whole
    :class:`hpfx_torch.solve.Scenarios` batch (``hpf_sweep`` with the
    filter's ``Y=`` override), descending the ``reduce="mean"`` or
    ``"max"`` aggregate of the per-scenario gradients.  A length-K
    ``bus`` sequence co-optimizes a K-branch bank.  ``v_limits`` /
    ``v_penalty``: the fundamental-voltage window, as a smooth quadratic
    barrier added to the objective and as a hard acceptance guard (the
    pure-THD objective has a degenerate minimum at voltage collapse);
    ``None`` disables both.
    """
    from .impedance import driving_point_impedance, resonance_peaks

    if reduce not in ("mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}: use 'mean' or 'max'")
    if functional is None:
        functional = _worst_thd
    if v_limits is None or v_penalty == 0.0:
        objective = functional
    else:
        def objective(V_m, V_a):
            v1 = V_m[0]
            over = torch.clamp_min(v1 - v_limits[1], 0.0)
            under = torch.clamp_min(v_limits[0] - v1, 0.0)
            return functional(V_m, V_a) + v_penalty * torch.sum(
                over * over + under * under)
    if optimizer is None:
        optimizer = Adam(learning_rate)
    b = dict(DEFAULT_FILTER_BOUNDS)
    b.update(bounds or {})
    if b["h_tune"][1] is None:
        b["h_tune"] = (b["h_tune"][0], float(settings.harmonics[-1]))
    rd, dv = settings.real_dtype, net.device
    multi = isinstance(bus, (list, tuple, np.ndarray))
    if multi:
        bus = tuple(int(x) for x in bus)
    if h_tune0 is None:
        zmag = driving_point_impedance(net, settings, devices=devices)
        _, worst_h, _ = resonance_peaks(zmag, settings)
        worst_h = worst_h.cpu().numpy().astype(float)
        h_tune0 = worst_h[list(bus)] if multi else float(worst_h[bus])
    t = lambda x: torch.as_tensor(x, dtype=rd, device=dv)
    if multi:
        h_tune0 = torch.broadcast_to(t(h_tune0), (len(bus),))
        x_cap0 = torch.broadcast_to(t(x_cap0), (len(bus),))

    def project(p):
        return FilterParams(h_tune=torch.clamp(p.h_tune, *b["h_tune"]),
                            x_cap=torch.clamp(p.x_cap, *b["x_cap"]))

    params = project(FilterParams(h_tune=t(h_tune0), x_cap=t(x_cap0)))
    Y0 = build_ybus(net, settings)

    def Y_of(p):
        return _filter_Y(Y0, settings, bus, p, quality)

    if scenarios is None:
        def solve_cold(p):
            return hpf(net, devices, settings, Y=Y_of(p))

        def grad_at(p, res):
            sens = filter_sensitivity(net, devices, settings, res, bus, p,
                                      quality=quality,
                                      functional=objective)
            return sens.value, sens.grad
    else:
        from .solve import hpf_sweep

        def solve_cold(p):
            return hpf_sweep(net, devices, settings, scenarios, Y=Y_of(p))

        def grad_at(p, res):
            sens = sweep_filter_sensitivity(
                net, devices, settings, res, scenarios, bus, p,
                quality=quality, functional=objective)
            if reduce == "mean":
                return (torch.mean(sens.value),
                        FilterParams(*(torch.mean(g, dim=0)
                                       for g in sens.grad)))
            worst = torch.argmax(sens.value)
            return (sens.value[worst],
                    FilterParams(*(g[worst] for g in sens.grad)))

    def _acceptable(res) -> bool:
        if not bool(res.converged.all()):
            return False
        if v_limits is None:
            return True
        v1 = res.V_m[..., 0, :]                 # fundamental, every bus
        return bool(((v1 >= v_limits[0]) & (v1 <= v_limits[1])).all())

    opt_state = optimizer.init(params)
    res = solve_cold(params)
    if not _acceptable(res):
        raise RuntimeError(
            "HPF does not converge (or violates v_limits) with the initial "
            "filter — start from different (h_tune0, x_cap0)")
    n_solves = 1
    value0, g = grad_at(params, res)
    value0 = float(value0)
    best_params, best_value = params, value0
    history = []

    dead_iters = 0
    for _ in range(steps):
        updates, opt_state = optimizer.update(g, opt_state, params)
        # COLD solves only, and an unacceptable proposal backtracks the
        # STEP (the optimizer state would otherwise keep pushing a frozen
        # update into the infeasible region)
        scale, res_new = 1.0, None
        for _try in range(6):
            proposal = project(FilterParams(
                *(p + scale * u for p, u in zip(params, updates))))
            cand = solve_cold(proposal)
            n_solves += 1
            if _acceptable(cand):
                res_new = cand
                break
            scale *= 0.5
        if res_new is None:
            history.append(float("nan"))
            dead_iters += 1
            if dead_iters >= 3:
                break               # the gradient keeps pointing into an
            continue                # infeasible region; stop burning solves
        dead_iters = 0
        params = proposal
        value, g = grad_at(params, res_new)
        value = float(value)
        history.append(value)
        if value < best_value:
            best_params, best_value = params, value

    return FilterOptResult(
        params=best_params, Y=Y_of(best_params),
        value=best_value, value0=value0,
        history=np.asarray(history, dtype=np.float64), n_solves=n_solves)
