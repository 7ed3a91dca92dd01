"""Hosting-capacity search (the port of :mod:`hpfx.capacity`): the
largest device penetration a feeder hosts while staying
harmonic-compliant, by bisection over a scalar multiplier applied to a
fixed set of Monte-Carlo scenario draws (common random numbers).

Every probe is a cold batched sweep of the same draws scaled to the
probed level; a non-converged scenario counts as non-compliant.  The
default bracket starts at today's penetration (``lo=1.0``): for coupled
devices the worst-bus THD is U-shaped in the level, and level 0.0 is
singular (see the JAX module's notes).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ._device import resolve_device
from .config import Settings
from .flows import IEEE519Summary, ieee519_screen
from .network import Network
from .solve import Scenarios, SweepSummary, hpf_sweep, summarize_thd


def monte_carlo_scenarios(seed: int, batch: int, net: Network,
                          settings: Settings, *,
                          p_spread: float = 0.2,
                          inj_spread: float = 0.2,
                          per_device: bool = True,
                          device=None) -> Scenarios:
    """A reusable Monte-Carlo scenario set around the nominal case: load
    and injection multipliers uniform within ``±p_spread``/``±inj_spread``
    of 1.0, per nonlinear bus with ``per_device`` ((batch, n_nl)).

    The draws are numpy's ``default_rng(seed)`` in the JAX package's
    order, so both packages assess the same scenarios; they are then
    cast to the settings' dtype on ``device`` (default: the CUDA card)."""
    dv = resolve_device(device)
    rng = np.random.default_rng(seed)
    rd = settings.real_dtype
    p = rng.uniform(1.0 - p_spread, 1.0 + p_spread, batch)
    shape = (batch, net.n_nonlinear) if per_device else (batch,)
    inj = rng.uniform(1.0 - inj_spread, 1.0 + inj_spread, shape)
    t = lambda a: torch.tensor(a, dtype=rd, device=dv)
    return Scenarios(p_scale=t(p), q_scale=t(p), injection_scale=t(inj))


def scale_scenarios(scenarios: Scenarios, level,
                    device_mask=None) -> Scenarios:
    """The base draws with their injection multipliers scaled by
    ``level``; with ``device_mask`` ((n_nl,), 0/1 or weights) only the
    masked devices scale and the rest keep their base draw."""
    inj = scenarios.injection_scale
    if inj is None:
        inj = torch.ones((scenarios.batch,), dtype=scenarios.p_scale.dtype,
                         device=scenarios.p_scale.device)
    lvl = torch.as_tensor(level, dtype=inj.dtype, device=inj.device)
    if device_mask is None:
        new = inj * lvl
    else:
        mask = torch.as_tensor(device_mask, dtype=inj.dtype,
                               device=inj.device)
        if inj.dim() == 1:
            inj = inj[:, None] * torch.ones_like(mask)[None, :]
        new = inj * (1.0 + (lvl - 1.0) * mask)
    return scenarios._replace(injection_scale=new)


def compliance_fraction(net: Network, devices, settings: Settings,
                        scenarios: Scenarios, *,
                        criterion: str = "thd",
                        thd_limit: float = 0.08,
                        v_kv: Optional[float] = None,
                        sweep=None):
    """Solve the batch and return ``(frac, summary)``: the fraction of
    scenarios both converged and compliant under ``criterion`` ("thd":
    worst-bus THD_F against ``thd_limit``; "ieee519": the standard's
    table limits for the ``v_kv`` class).  ``sweep``: any callable with
    :func:`hpf_sweep`'s ``(net, devices, settings, scenarios)``
    signature."""
    run = sweep if sweep is not None else hpf_sweep
    res = run(net, devices, settings, scenarios)
    if criterion == "thd":
        summary = summarize_thd(res, thd_limit)
        ok = summary.converged & (summary.max_thd_f <= thd_limit)
        frac = float(ok.cpu().numpy().mean())
    elif criterion == "ieee519":
        summary = ieee519_screen(res, settings, v_kv)
        frac = float(summary.compliant.cpu().numpy().mean())
    else:
        raise ValueError(f"unknown criterion {criterion!r} "
                         "(use 'thd' or 'ieee519')")
    return frac, summary


class HostingCapacityResult(NamedTuple):
    """Outcome of :func:`find_hosting_capacity`
    (``hpfx.capacity.HostingCapacityResult``): ``feasible`` (the ``lo``
    level meets the target), the level found and its fraction, every
    probe in order, the screen at the level, and ``bracket_open`` when
    ``hi`` itself was still compliant."""
    feasible: bool
    level: float
    frac_at_level: float
    levels: Sequence[float]
    fracs: Sequence[float]
    summary: Union[SweepSummary, IEEE519Summary, None]
    bracket_open: bool = False


def find_hosting_capacity(net: Network, devices, settings: Settings,
                          scenarios: Scenarios, *,
                          confidence: float = 0.95,
                          criterion: str = "thd",
                          thd_limit: float = 0.08,
                          v_kv: Optional[float] = None,
                          lo: float = 1.0, hi: float = 4.0,
                          tol: float = 0.01,
                          max_probes: int = 32,
                          device_mask=None,
                          sweep=None) -> HostingCapacityResult:
    """Bisect ``[lo, hi]`` for the largest level whose compliance
    fraction stays at or above ``confidence``; stops when the bracket is
    narrower than ``tol`` or after ``max_probes`` steps, and returns the
    largest level actually probed compliant."""
    levels, fracs = [], []

    def probe(lvl):
        frac, summary = compliance_fraction(
            net, devices, settings,
            scale_scenarios(scenarios, lvl, device_mask),
            criterion=criterion, thd_limit=thd_limit, v_kv=v_kv,
            sweep=sweep)
        levels.append(float(lvl))
        fracs.append(frac)
        return frac, summary

    f_lo, s_lo = probe(lo)
    if f_lo < confidence:
        return HostingCapacityResult(False, float("nan"), f_lo,
                                     levels, fracs, s_lo)
    f_hi, s_hi = probe(hi)
    if f_hi >= confidence:
        return HostingCapacityResult(True, hi, f_hi, levels, fracs, s_hi,
                                     bracket_open=True)
    best, f_best, s_best = lo, f_lo, s_lo
    a, b = lo, hi
    for _ in range(max_probes):
        if b - a <= tol:
            break
        mid = 0.5 * (a + b)
        f, s = probe(mid)
        if f >= confidence:
            a, best, f_best, s_best = mid, mid, f, s
        else:
            b = mid
    return HostingCapacityResult(True, best, f_best, levels, fracs, s_best)
