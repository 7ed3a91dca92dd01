"""Batched scenario sweeps: the port of the sweep entry points of
:mod:`hpfx.solve`.

:func:`hpf_sweep_device` is the main path: the adaptive lane-major sweep
(:func:`hpfx_torch.lanes.hpf_sweep_adaptive_lanes`) followed, only when
lanes remain unconverged, by the deterministic host-driven rescue
(:func:`_rescue_sweep`), whose last pass re-solves the remaining
stragglers in float64 on the same device (:func:`_f64_resolve`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .config import Settings
from .devices import DeviceSet
from .fundamental import FundResult
from .harmonic import HPFResult
from .lanes import (PhaseLog, _phase, hpf_sweep_adaptive_lanes,
                    hpf_sweep_lanes, supports_lanes)
from .network import Network


class Scenarios(NamedTuple):
    """Per-scenario multipliers over a batch of B cases: ``p_scale`` /
    ``q_scale`` (B,) or (B, n) bus load scaling, ``injection_scale`` (B,)
    or (B, n_nl) Norton scaling (per scenario or per device)."""
    p_scale: torch.Tensor
    q_scale: Optional[torch.Tensor] = None
    injection_scale: Optional[torch.Tensor] = None


def hpf_sweep(net: Network, devices: DeviceSet, settings: Settings,
              scenarios: Scenarios, V0=None,
              log: Optional[PhaseLog] = None) -> HPFResult:
    """Solve B independent HPF cases in the lane-major layout; returns a
    batch-major :class:`HPFResult`.  ``V0``: optional batch-major (V_m,
    V_a) warm starts.  Configurations the lane-major path does not cover
    (dense solver, no Norton devices) are not ported."""
    if not supports_lanes(devices, settings, net):
        raise NotImplementedError(
            "hpfx_torch sweeps need solver='arrow' and a non-empty Norton "
            "DeviceSet (the lane-major path); the vmap layout is not ported")
    return hpf_sweep_lanes(net, devices, settings, scenarios, V0=V0, log=log)


def _take_scen(scenarios: Scenarios, idx) -> Scenarios:
    return Scenarios(*(None if x is None else x[idx] for x in scenarios))


def _cast_result(r: HPFResult, dtype) -> HPFResult:
    """Cast every floating tensor of a result (fund included) to dtype."""
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    fund = None if r.fund is None else FundResult(*map(cast, r.fund))
    return HPFResult(*map(cast, r[:-1]), fund=fund)


def _f64_resolve(net: Network, devices: DeviceSet, settings: Settings,
                 sub: Scenarios, log: Optional[PhaseLog] = None) -> HPFResult:
    """Re-solve a (small) scenario subset cold in float64 on the same
    device.  The knife-edge f32 class converges in f64 on the same draws,
    so the last rescue resort is more precision.  ``converged`` reflects
    the f64 criterion; the result is cast back to the caller's dtype."""
    f64 = torch.float64
    r = hpf_sweep_lanes(net.to(dtype=f64), devices.to(dtype=f64),
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
