"""Single cases and batched scenario sweeps: the port of the entry points
of :mod:`hpfx.solve`.

:func:`hpf_single` solves one case.  :func:`hpf_sweep` solves a batch in
one of two layouts: lane-major (``hpfx_torch.lanes``, the arrow solver
with Norton devices) or batch-major, the JAX package's ``vmap`` layout
(:func:`_hpf_sweep_vmap`), which takes every configuration.
:func:`hpf_sweep_device` is the net2 main path: the adaptive lane-major
sweep (:func:`hpfx_torch.lanes.hpf_sweep_adaptive_lanes`) followed, only
when lanes remain unconverged, by the deterministic host-driven rescue
(:func:`_rescue_sweep`), whose last pass re-solves the remaining
stragglers in float64 on the same device (:func:`_f64_resolve`).
:func:`hpf_sweep_adaptive` is the host-driven two-phase schedule of the
net1-class sweeps, ending in the same rescue.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .config import Settings
from .devices import DeviceSet
from .fundamental import FundResult, solve_fundamental
from .harmonic import HPFResult, solve_harmonic
from .lanes import (PhaseLog, _phase, _trip, hpf_sweep_adaptive_lanes,
                    hpf_sweep_lanes, supports_lanes)
from .network import Network
from .ybus import build_ybus, line_ybus_pair, resolve_ybus


class Scenarios(NamedTuple):
    """Per-scenario multipliers over a batch of B cases: ``p_scale`` /
    ``q_scale`` (B,) or (B, n) bus load scaling, ``injection_scale`` (B,)
    or (B, n_nl) Norton scaling (per scenario or per device)."""
    p_scale: torch.Tensor
    q_scale: Optional[torch.Tensor] = None
    injection_scale: Optional[torch.Tensor] = None


def hpf_single(net: Network, devices: DeviceSet,
               settings: Settings, I_bg=None) -> HPFResult:
    """Single-case harmonic power flow (``hpfx.solve.hpf_single``): the
    admittances and, with ``settings.stable_mismatch``, their line
    structure, then the fundamental and the harmonic Newton solves.
    ``I_bg`` is not ported and raises."""
    Y = build_ybus(net, settings)
    lineY, lineY_f = line_ybus_pair(net, settings)
    fund = solve_fundamental(Y[0], net, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net, devices, settings, lineY=lineY,
                          I_bg=I_bg)


def hpf_sweep(net: Network, devices: DeviceSet, settings: Settings,
              scenarios: Scenarios, V0=None,
              log: Optional[PhaseLog] = None) -> HPFResult:
    """Solve B independent HPF cases; returns a batch-major
    :class:`HPFResult`.  ``V0``: optional batch-major (V_m, V_a) warm
    starts.

    ``settings.layout`` picks the layout, on either device as the JAX
    package picks it on its TPU: "vmap" the batch-major loop
    (:func:`_hpf_sweep_vmap`); "lanes" and "auto" the lane-major path
    where it applies (:func:`hpfx_torch.lanes.supports_lanes`: the arrow
    solver with Norton devices), the batch-major loop otherwise.
    ``log`` counts the Newton loop trips (fundamental and harmonic) in
    its current phase."""
    if settings.layout != "vmap" and supports_lanes(devices, settings, net):
        return hpf_sweep_lanes(net, devices, settings, scenarios, V0=V0,
                               log=log)
    res = _hpf_sweep_vmap(net, devices, settings, scenarios, V0=V0)
    if log is not None:
        # the batch-major loops run as many trips as their longest scenario
        for _ in range(int(res.fund.n_iter.max()) + int(res.n_iter.max())):
            _trip(log)
    return res


def _hpf_sweep_vmap(net: Network, devices: DeviceSet, settings: Settings,
                    scenarios: Scenarios, V0=None) -> HPFResult:
    """The JAX package's ``vmap`` layout (``hpfx.solve._solve_scenario``
    under ``vmap``) as a batch-major loop: the single-case solvers run on
    (B, ...) tensors, and each scenario stops updating when its own test
    fails, as JAX's while-loop batching rule does; ``n_iter`` and
    ``err_hist`` are per scenario.  The Newton solves see the whole batch
    on every iteration, converged scenarios included."""
    Y, lineY, lineY_f = resolve_ybus(net, settings)
    # batch-major (B, n) loads and the devices scaled per scenario
    p = scenarios.p_scale
    q = scenarios.q_scale if scenarios.q_scale is not None else p
    inj = scenarios.injection_scale
    if inj is None:
        inj = torch.ones_like(p)
    col = lambda x: (x[:, None] if x.dim() == 1 else x).to(net.bus_P.dtype)
    net_s = dataclasses.replace(net, bus_P=net.bus_P * col(p),
                                bus_Q=net.bus_Q * col(q))
    dev_s = devices.scale(col(inj))
    fund = solve_fundamental(Y[0], net_s, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net_s, dev_s, settings, V0=V0,
                          lineY=lineY)


def _take_scen(scenarios: Scenarios, idx) -> Scenarios:
    return Scenarios(*(None if x is None else x[idx] for x in scenarios))


def _cast_result(r: HPFResult, dtype) -> HPFResult:
    """Cast every floating tensor of a result (fund included) to dtype."""
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    fund = None if r.fund is None else FundResult(*map(cast, r.fund))
    traj = None if r.trajectory is None else cast(r.trajectory)
    return HPFResult(*map(cast, r[:6]), fund=fund, trajectory=traj)


def _f64_resolve(net: Network, devices: DeviceSet, settings: Settings,
                 sub: Scenarios, log: Optional[PhaseLog] = None) -> HPFResult:
    """Re-solve a (small) scenario subset cold in float64 on the same
    device.  The knife-edge f32 class converges in f64 on the same draws,
    so the last rescue resort is more precision.  ``converged`` reflects
    the f64 criterion; the result is cast back to the caller's dtype."""
    f64 = torch.float64
    r = hpf_sweep(net.to(dtype=f64), devices.to(dtype=f64),
                  settings.with_(dtype="float64"),
                  Scenarios(*(None if x is None else x.to(f64)
                              for x in sub)), log=log)
    return _cast_result(r, settings.real_dtype)


def _put(full, idx, val):
    out = full.clone()
    out[idx] = val
    return out


def _bucket_pending(converged, B: int):
    """Indices of unconverged scenarios padded, with repeats of the first,
    to the next power of two (at most B); None when all converged."""
    pend = torch.nonzero(~converged).flatten()
    if pend.numel() == 0:
        return None
    bucket = min(1 << (pend.numel() - 1).bit_length(), B)
    return torch.cat([pend, pend[:1].expand(bucket - pend.numel())])


def _rescue_sweep(settings: Settings, scenarios: Scenarios, out: HPFResult,
                  run, run64=None) -> HPFResult:
    """Deterministic straggler rescue (``hpfx.solve._rescue_sweep``):
    re-solve unconverged scenarios with a fresh budget, first warm from
    their own final state (flat where it went non-finite), then from the
    cold flat start; ``run64`` re-solves what survives both in float64.
    ``run(sub, V0)`` and ``run64(sub)`` return batch-major results."""
    def merge(out, idx, res_r):
        return out._replace(
            V_m=_put(out.V_m, idx, res_r.V_m),
            V_a=_put(out.V_a, idx, res_r.V_a),
            err=_put(out.err, idx, res_r.err),
            n_iter=_put(out.n_iter, idx, out.n_iter[idx] + res_r.n_iter),
            err_hist=_put(out.err_hist, idx, res_r.err_hist),
            converged=_put(out.converged, idx, res_r.converged))

    B = out.V_m.shape[0]
    flat_m = torch.full(out.V_m.shape[1:], settings.v_init_h,
                        dtype=out.V_m.dtype, device=out.V_m.device)
    flat_m[0] = settings.v_init_f
    flat_a = torch.full_like(flat_m, settings.a_init_h)
    flat_a[0] = settings.a_init_f
    for use_self in (True, False):
        idx = _bucket_pending(out.converged, B)
        if idx is None:
            return out
        if use_self:
            Vm0, Va0 = out.V_m[idx], out.V_a[idx]
            finite = (torch.isfinite(Vm0).flatten(1).all(dim=1)
                      & torch.isfinite(Va0).flatten(1).all(dim=1))
            Vm0 = torch.where(finite[:, None, None], Vm0, flat_m)
            Va0 = torch.where(finite[:, None, None], Va0, flat_a)
        else:
            Vm0 = flat_m.expand((idx.numel(),) + flat_m.shape)
            Va0 = flat_a.expand((idx.numel(),) + flat_a.shape)
        out = merge(out, idx, run(_take_scen(scenarios, idx), (Vm0, Va0)))
    if run64 is not None and settings.real_dtype != torch.float64:
        idx = _bucket_pending(out.converged, B)
        if idx is not None:
            out = merge(out, idx, run64(_take_scen(scenarios, idx)))
    return out


def hpf_sweep_device(net: Network, devices: DeviceSet, settings: Settings,
                     scenarios: Scenarios, phase_iters: int = 16,
                     rescue: bool = True, warm: str = "cold",
                     rescue_width=None,
                     log: Optional[PhaseLog] = None) -> HPFResult:
    """The device-side adaptive sweep plus the host straggler rescue
    (``hpfx.solve.hpf_sweep_device``).

    Runs :func:`hpfx_torch.lanes.hpf_sweep_adaptive_lanes` (phase-capped
    trip, gathered warm re-solve, cold restart), then — only when lanes
    remain unconverged — :func:`_rescue_sweep`, ending in the float64
    re-solve.  ``warm="linear"`` starts phase 1 from the exact-linear
    Norton seed.  ``log``: optional :class:`hpfx_torch.lanes.PhaseLog`
    that records each phase's time and Newton trips."""
    out = hpf_sweep_adaptive_lanes(net, devices, settings, scenarios,
                                   phase_iters=phase_iters,
                                   rescue_width=rescue_width, warm=warm,
                                   log=log)
    if rescue and not bool(out.converged.all()):
        with _phase(log, "host_rescue", net.device):
            out = _rescue_sweep(
                settings, scenarios, out,
                lambda sub, V0_: hpf_sweep(net, devices, settings, sub,
                                           V0=V0_, log=log),
                run64=lambda sub: _f64_resolve(net, devices, settings, sub,
                                               log=log))
    return out


def hpf_sweep_adaptive(net: Network, devices: DeviceSet, settings: Settings,
                       scenarios: Scenarios, phase_iters: int = 16,
                       phase2_settings: Optional[Settings] = None,
                       V0=None, rescue: bool = True, warm: str = "cold",
                       log: Optional[PhaseLog] = None) -> HPFResult:
    """Host-driven two-phase sweep (``hpfx.solve.hpf_sweep_adaptive``).

    Phase 1 caps the Newton trip at ``phase_iters``; phase 2 re-solves the
    unconverged scenarios, bucketed to a power of two, warm from their
    phase-1 states with ``phase2_settings`` (default ``settings``) and
    the remaining budget.  ``err_hist`` is NaN-padded to ``max_iter_h``,
    with the phase-2 history spliced in at the phase-1 offset, and
    ``n_iter`` sums both phases.  ``rescue`` runs :func:`_rescue_sweep`
    on what is still unconverged (self-warm, cold, then float64).
    ``V0``: optional batch-major (V_m, V_a) phase-1 start.
    ``warm="linear"`` (the exact-linear Norton seed) is not ported on
    this schedule.  ``log``: optional :class:`PhaseLog` with the phases
    "phase1", "phase2" and "host_rescue"."""
    if V0 is None and warm == "linear":
        raise NotImplementedError(
            "warm='linear' on the host schedule needs "
            "warmstart.norton_warm_start, which is not ported; pass V0 or "
            "use warm='cold' (hpf_sweep_device takes warm='linear')")
    dv = net.device

    def rescue_(out):
        with _phase(log, "host_rescue", dv):
            return _rescue_sweep(
                settings, scenarios, out,
                lambda sub, V0_: hpf_sweep(net, devices, settings, sub,
                                           V0=V0_, log=log),
                run64=lambda sub: _f64_resolve(net, devices, settings, sub,
                                               log=log))

    p1 = min(phase_iters, settings.max_iter_h)
    s1 = settings.with_(max_iter_h=p1)
    with _phase(log, "phase1", dv):
        r1 = hpf_sweep(net, devices, s1, scenarios, V0=V0, log=log)
    B = r1.V_m.shape[0]
    hist = torch.full((B, settings.max_iter_h), float("nan"),
                      dtype=r1.err_hist.dtype, device=dv)
    hist[:, :p1] = r1.err_hist
    idx = _bucket_pending(r1.converged, B)
    if idx is None or p1 == settings.max_iter_h:
        r1 = r1._replace(err_hist=hist)
        return rescue_(r1) if rescue and idx is not None else r1

    base2 = settings if phase2_settings is None else phase2_settings
    s2 = base2.with_(max_iter_h=settings.max_iter_h - p1)
    with _phase(log, "phase2", dv):
        r2 = hpf_sweep(net, devices, s2, _take_scen(scenarios, idx),
                       V0=(r1.V_m[idx], r1.V_a[idx]), log=log)
    # re-solved scenarios ran all p1 trips of phase 1, so their phase-2
    # history continues at that offset (err after trip i at [i])
    hist[idx, p1:] = r2.err_hist
    merged = HPFResult(
        V_m=_put(r1.V_m, idx, r2.V_m), V_a=_put(r1.V_a, idx, r2.V_a),
        err=_put(r1.err, idx, r2.err),
        n_iter=_put(r1.n_iter, idx, r1.n_iter[idx] + r2.n_iter),
        err_hist=hist, converged=_put(r1.converged, idx, r2.converged),
        fund=r1.fund)
    return rescue_(merged) if rescue else merged
