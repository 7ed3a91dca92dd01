"""Sensitivities of the harmonic power flow solution by the implicit
function theorem (the port of :mod:`hpfx.sensitivity`).

At a converged fixed point x*, f(x*, θ) = 0 gives

    dx*/dθ = −J(x*)^{-1} · ∂f/∂θ,

with J the harmonic Jacobian the solver builds and ∂f/∂θ taken by
forward-mode autodiff of the mismatch; the gradient of a functional g is
then ∇_x g · dx*/dθ.

Only plain tensor code goes through ``torch.func``: ``jacfwd`` of the
mismatch (vectorized over scenarios by ``vmap``) and ``grad`` of the
functional.  The linear solve against J is not differentiated: it runs
once, outside any transform, on the stacked (B, P) right-hand sides,
through :func:`hpfx_torch.arrow.arrow_solve` (``settings.solver ==
"arrow"``) or :func:`hpfx_torch.ops.batched_solve.batched_solve` (the
dense Jacobian), so that float32 solves reach the card's kernels.  Every
entry point runs as a batch: a single case is a batch of one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .config import Settings
from .cx import Cx
from .devices import DeviceSet
from .harmonic import (HPFResult, build_harmonic_jacobian, harmonic_mismatch,
                       harmonic_state_vector, update_harmonic_voltages)
from .network import Network
from .ops.batched_solve import batched_solve
from .results import get_thd
from .ybus import build_ybus


class ScenarioParams(NamedTuple):
    """Differentiation point: the scales at which the result was solved;
    ``p_scale``/``q_scale`` scalar or (n,), ``injection_scale`` scalar or
    (n_nl,)."""
    p_scale: object = 1.0
    q_scale: object = 1.0
    injection_scale: object = 1.0


class Sensitivity(NamedTuple):
    value: torch.Tensor      # g(x*) at the solution
    grad: object             # dg/dθ, shaped like the parameters
    dx: torch.Tensor         # dx*/dθ, stacked columns (dim, P)


class LineParams(NamedTuple):
    """Line parameters for :func:`line_sensitivity`: ``z_scale`` (scalar
    or (L,)) on series R and X, per-line tap ratios ``tau`` and phase
    shifts ``shift_rad`` (default: the network's own)."""
    z_scale: object = 1.0
    tau: object = None
    shift_rad: object = None


class FilterParams(NamedTuple):
    """Single-tuned shunt filter design (see
    :func:`hpfx_torch.impedance.tuned_filter_admittance`): scalar leaves
    for one filter, (K,) leaves for a K-branch bank."""
    h_tune: object = 7.0
    x_cap: object = 1.0


def _worst_thd(V_m, V_a):
    return get_thd(V_m).THD_F.amax()


def _params(p, rd, dv):
    return type(p)(*(torch.as_tensor(x, dtype=rd, device=dv) for x in p))


def _leaves(theta):
    """The tensors of a parameter NamedTuple, or the one tensor."""
    return list(theta) if isinstance(theta, tuple) else [theta]


def _like(theta, leaves):
    """``leaves`` in ``theta``'s structure (:func:`_leaves` inverted)."""
    return type(theta)(*leaves) if isinstance(theta, tuple) else leaves[0]


def _solve_columns(V_m, V_a, Y, dev_t, net: Network, settings: Settings,
                   cols):
    """J(x*)^{-1}·cols for every scenario: V_m/V_a (B, H, n), ``dev_t``
    the (batch-major) devices J is built with, cols (B, dim, P)."""
    m, n, c = net.m, net.n, net.c
    if settings.solver == "arrow":
        from .arrow import (ArrowPieces, arrow_solve, build_arrow_pieces,
                            make_arrow_index)
        idx = make_arrow_index(settings.n_harmonics, n, m, c)
        pieces = build_arrow_pieces(V_m, V_a, Y, dev_t, idx)
        P = cols.shape[-1]
        per_col = lambda t: t[:, None].expand((t.shape[0], P) + t.shape[1:])
        pieces = ArrowPieces(*map(per_col, pieces))
        return arrow_solve(pieces, cols.mT, idx).mT
    return batched_solve(build_harmonic_jacobian(V_m, V_a, Y, dev_t, m, n, c),
                         cols)


def _ift(f_of, theta, V_m, V_a, Y, dev_t, net: Network, settings: Settings,
         functional, extra=()):
    """The implicit-function-theorem gradient over a batch of B solved
    scenarios.

    ``f_of(theta_i, V_m_i, V_a_i, *extra_i)``: one scenario's mismatch at
    its solution as a function of its parameters ``theta_i``; ``theta`` (a
    parameter NamedTuple or one tensor) and ``extra`` carry a leading B.
    ``Y``/``dev_t``: the operating point J is built at.  Returns
    ``(value (B,), grad (theta's structure, leading B), dx (B, dim,
    P))``."""
    H, n, c = settings.n_harmonics, net.n, net.c
    B = V_m.shape[0]
    df = torch.func.vmap(torch.func.jacfwd(f_of))(theta, V_m, V_a, *extra)
    dim = V_m[0].numel() * 2 - 1 - c
    cols = torch.cat([d.reshape(B, dim, -1) for d in _leaves(df)],
                     dim=-1)                                  # (B, dim, P)
    dx = -_solve_columns(V_m, V_a, Y, dev_t, net, settings, cols)

    def g_of_x(x, vm, va):
        return functional(*update_harmonic_voltages(vm, va, x, H, n, c))

    x_star = harmonic_state_vector(V_m, V_a, c)
    dg, value = torch.func.vmap(torch.func.grad_and_value(g_of_x))(
        x_star, V_m, V_a)
    grad_flat = torch.einsum("bd,bdp->bp", dg, dx)
    out, off = [], 0
    for leaf in _leaves(theta):
        k = max(1, leaf[0].numel())
        out.append(grad_flat[:, off:off + k].reshape(leaf.shape))
        off += k
    return value, _like(theta, out), dx


def _single(f_of, theta, result: HPFResult, Y, dev_t, net, settings,
            functional) -> Sensitivity:
    """:func:`_ift` on one solved case, a batch of one."""
    value, grad, dx = _ift(
        f_of, _like(theta, [t[None] for t in _leaves(theta)]),
        result.V_m[None], result.V_a[None], Y, dev_t, net, settings,
        functional)
    return Sensitivity(value=value[0],
                       grad=_like(grad, [t[0] for t in _leaves(grad)]),
                       dx=dx[0])


def _loads(net: Network, p, q) -> Cx:
    return Cx(net.bus_P * p, net.bus_Q * q)


def scenario_sensitivity(
    net: Network, devices, settings: Settings,
    result: HPFResult, params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional(V_m, V_a)`` (default: the worst-bus
    THD_F) with respect to every scenario parameter at a converged
    solution; ``params``: the :class:`ScenarioParams` it was solved at
    (default all-ones).  ``grad`` is a ScenarioParams shaped like it."""
    functional = functional or _worst_thd
    rd, dv = settings.real_dtype, net.device
    params = _params(params or ScenarioParams(), rd, dv)
    m, n, c = net.m, net.n, net.c
    Y = build_ybus(net, settings)

    def f_of(pr, vm, va):
        return harmonic_mismatch(vm, va, Y, _loads(net, pr.p_scale,
                                                   pr.q_scale),
                                 devices.scale(pr.injection_scale),
                                 m, n, c)[0]

    return _single(f_of, params, result, Y,
                   devices.scale(params.injection_scale), net, settings,
                   functional)


def mix_sensitivity(
    net: Network, library, settings: Settings,
    result: HPFResult, w,
    params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional`` with respect to the (n_nl, T) device-mix
    weights ``w`` of a :class:`hpfx_torch.devices.DeviceLibrary` at a
    converged mix solve (mixed first, then scaled by ``params``);
    ``grad`` is (n_nl, T)."""
    functional = functional or _worst_thd
    rd, dv = settings.real_dtype, net.device
    params = _params(params or ScenarioParams(), rd, dv)
    w = torch.as_tensor(w, dtype=rd, device=dv)
    m, n, c = net.m, net.n, net.c
    Y = build_ybus(net, settings)
    S = _loads(net, params.p_scale, params.q_scale)

    def f_of(w_, vm, va):
        dev = library.mixed(w_).scale(params.injection_scale)
        return harmonic_mismatch(vm, va, Y, S, dev, m, n, c)[0]

    return _single(f_of, w, result, Y,
                   library.mixed(w).scale(params.injection_scale), net,
                   settings, functional)


def _sweep_inputs(scenarios, settings: Settings, dv):
    """(p, q, inj, mix) of a sweep with ``hpf_sweep``'s defaults: q
    follows p, injections default to one."""
    rd = settings.real_dtype
    t = lambda x: torch.as_tensor(x, dtype=rd, device=dv)
    p = t(scenarios.p_scale)
    q = p if scenarios.q_scale is None else t(scenarios.q_scale)
    inj = (torch.ones((scenarios.batch,), dtype=rd, device=dv)
           if scenarios.injection_scale is None
           else t(scenarios.injection_scale))
    return p, q, inj, scenarios.device_mix


def _batch_devices(devices, inj, mix):
    """The devices of every scenario, batch-major, as the vmap layout
    builds them (mixed first, then scaled)."""
    base = devices.mixed(mix) if mix is not None else devices
    return base.scale(inj[:, None] if inj.dim() == 1 else inj)


def sweep_sensitivity(
    net: Network, devices, settings: Settings,
    sweep_result, scenarios,
    functional: Callable = None,
) -> Sensitivity:
    """Per-scenario (p, q, injection) gradients of ``functional`` for a
    whole sweep: value (B,), grad a ScenarioParams with leading B, dx
    (B, dim, P).  ``scenarios``: the sweep's
    :class:`hpfx_torch.solve.Scenarios` (a ``device_mix`` is carried, not
    differentiated).  Gradients of non-converged scenarios mean nothing:
    mask them with ``sweep_result.converged``."""
    functional = functional or _worst_thd
    p, q, inj, mix = _sweep_inputs(scenarios, settings, net.device)
    m, n, c = net.m, net.n, net.c
    Y = build_ybus(net, settings)

    def f_of(pr, vm, va, *w):
        base = devices.mixed(w[0]) if w else devices
        return harmonic_mismatch(vm, va, Y, _loads(net, pr.p_scale,
                                                   pr.q_scale),
                                 base.scale(pr.injection_scale),
                                 m, n, c)[0]

    value, grad, dx = _ift(
        f_of, ScenarioParams(p, q, inj), sweep_result.V_m, sweep_result.V_a,
        Y, _batch_devices(devices, inj, mix), net, settings, functional,
        extra=() if mix is None else (mix,))
    return Sensitivity(value=value, grad=grad, dx=dx)


def line_sensitivity(
    net: Network, devices, settings: Settings,
    result: HPFResult, line_params: Optional[LineParams] = None,
    scenario_params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional`` with respect to line parameters
    (series-impedance scale, tap ratio, phase shift) at a converged
    solution, ∂f/∂θ by forward-mode autodiff through the Ybus assembly;
    ``grad`` is a LineParams of per-line leaves."""
    functional = functional or _worst_thd
    rd, dv = settings.real_dtype, net.device
    lp = line_params or LineParams()
    sp = _params(scenario_params or ScenarioParams(), rd, dv)
    t = lambda x: torch.as_tensor(x, dtype=rd, device=dv)
    lp = LineParams(
        z_scale=t(lp.z_scale),
        tau=t(net.line_tau if lp.tau is None else lp.tau),
        shift_rad=t(net.line_shift if lp.shift_rad is None
                    else lp.shift_rad))
    m, n, c = net.m, net.n, net.c
    S = _loads(net, sp.p_scale, sp.q_scale)
    dev_t = devices.scale(sp.injection_scale)

    def f_of(pr, vm, va):
        net_p = dataclasses.replace(
            net, line_R=net.line_R * pr.z_scale,
            line_X=net.line_X * pr.z_scale,
            line_tau=pr.tau, line_shift=pr.shift_rad)
        return harmonic_mismatch(vm, va, build_ybus(net_p, settings), S,
                                 dev_t, m, n, c)[0]

    # J at the solved point: the default parameters rebuild net's Ybus
    return _single(f_of, lp, result, build_ybus(net, settings), dev_t, net,
                   settings, functional)


def injection_sensitivity(
    net: Network, devices: DeviceSet, settings: Settings,
    result: HPFResult, theta=1.0,
    functional: Callable = None,
) -> Sensitivity:
    """d(functional)/d(injection scale) at a converged solution, ``theta``
    the scale it was solved at (scalar, or (n_nl,) per device)."""
    params = ScenarioParams(injection_scale=theta)
    sens = scenario_sensitivity(net, devices, settings, result,
                                params=params, functional=functional)
    grad = sens.grad.injection_scale
    # dx columns run leaf by leaf in ScenarioParams order
    off = sum(max(1, torch.as_tensor(p).numel())
              for p in (params.p_scale, params.q_scale))
    dx = sens.dx[:, off:]
    if torch.as_tensor(theta).dim() == 0:
        grad = grad.reshape(())
        dx = dx[:, 0]
    return Sensitivity(value=sens.value, grad=grad, dx=dx)


def _filter_Y(Y0, settings, bus, p: FilterParams, quality):
    """``Y0`` with the filter (scalar leaves, ``bus`` an int) or bank
    ((K,) leaves, ``bus`` a length-K sequence) installed."""
    from .impedance import (install_shunt, install_shunts,
                            tuned_filter_admittance)
    yf = tuned_filter_admittance(settings, p.h_tune, p.x_cap, quality)
    if p.h_tune.dim() == 0 and p.x_cap.dim() == 0:
        return install_shunt(Y0, bus, yf)
    return install_shunts(Y0, bus, yf)


def filter_sensitivity(
    net: Network, devices, settings: Settings,
    result: HPFResult, bus, filter_params: FilterParams,
    quality: float = 30.0,
    scenario_params: Optional[ScenarioParams] = None,
    functional: Callable = None,
) -> Sensitivity:
    """Gradient of ``functional`` with respect to a tuned filter's design
    (or a bank's, with (K,) leaves and K buses) at a converged solution
    solved WITH the filter in service (the ``Y=`` override, so the plain
    dense mismatch); ∂f/∂θ through the filter admittance and the Ybus
    diagonal."""
    functional = functional or _worst_thd
    rd, dv = settings.real_dtype, net.device
    sp = _params(scenario_params or ScenarioParams(), rd, dv)
    fp = _params(filter_params, rd, dv)
    m, n, c = net.m, net.n, net.c
    S = _loads(net, sp.p_scale, sp.q_scale)
    dev_t = devices.scale(sp.injection_scale)
    Y0 = build_ybus(net, settings)

    def f_of(pr, vm, va):
        return harmonic_mismatch(vm, va, _filter_Y(Y0, settings, bus, pr,
                                                   quality),
                                 S, dev_t, m, n, c)[0]

    # J at the solved point: the filter is part of the operating point
    return _single(f_of, fp, result, _filter_Y(Y0, settings, bus, fp,
                                               quality),
                   dev_t, net, settings, functional)


def sweep_filter_sensitivity(
    net: Network, devices, settings: Settings,
    sweep_result, scenarios, bus, filter_params: FilterParams,
    quality: float = 30.0,
    functional: Callable = None,
) -> Sensitivity:
    """Per-scenario gradients of ``functional`` with respect to ONE shared
    tuned filter's design over a whole sweep solved with it installed
    (``hpf_sweep(..., Y=Yf)``): value (B,), grad FilterParams with
    leading B, dx (B, dim, 2)."""
    functional = functional or _worst_thd
    rd, dv = settings.real_dtype, net.device
    fp = _params(filter_params, rd, dv)
    p, q, inj, mix = _sweep_inputs(scenarios, settings, dv)
    B = p.shape[0]
    m, n, c = net.m, net.n, net.c
    Y0 = build_ybus(net, settings)

    def f_of(pr, vm, va, p_s, q_s, i_s, *w):
        base = devices.mixed(w[0]) if w else devices
        return harmonic_mismatch(vm, va, _filter_Y(Y0, settings, bus, pr,
                                                   quality),
                                 _loads(net, p_s, q_s), base.scale(i_s),
                                 m, n, c)[0]

    # the shared design, one copy per scenario
    theta = FilterParams(*(x.expand((B,) + x.shape) for x in fp))
    value, grad, dx = _ift(
        f_of, theta, sweep_result.V_m, sweep_result.V_a,
        _filter_Y(Y0, settings, bus, fp, quality),
        _batch_devices(devices, inj, mix), net, settings, functional,
        extra=(p, q, inj) + (() if mix is None else (mix,)))
    return Sensitivity(value=value, grad=grad, dx=dx)
