"""Harmonic studies on top of the batched sweeps: percentile assessment
and quasi-static time series (the port of :mod:`hpfx.studies`).

- :func:`assess_quantiles` — Monte-Carlo percentile assessment of a
  scenario distribution (compose with
  :func:`hpfx_torch.capacity.monte_carlo_scenarios`);
- :func:`run_timeseries` / :func:`percentile_compliance` — a profile
  study whose time steps are the batch axis (chunked for long profiles)
  and the 95th-percentile IEEE-519 screen over its window.

Non-converged rows are NaN-masked out of every statistic
(``torch.nanquantile``, linear interpolation as ``jnp.nanquantile``) and
the converged fraction is always reported.  ``sweep=`` takes any of the
port's sweep callables with :func:`hpfx_torch.solve.hpf_sweep`'s
``(net, devices, settings, scenarios)`` signature.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .config import Settings
from .flows import _distortion_pct, _limits_for
from .fundamental import FundResult
from .harmonic import HPFResult
from .network import Network
from .solve import Scenarios, hpf_sweep


def _masked_rows(values: torch.Tensor, converged: torch.Tensor):
    """NaN out the batch rows (values (B, ...)) whose solve did not
    converge (converged (B,))."""
    mask = converged.to(torch.bool).reshape((-1,) + (1,) * (values.dim() - 1))
    return torch.where(mask, values, torch.full_like(values, float("nan")))


def _quantiles(values, q: Sequence[float]):
    """nanquantile over the batch axis at the probabilities ``q`` (a
    sequence: (Q, ...) out; a float: the trailing shape)."""
    qt = torch.as_tensor(q, dtype=values.dtype, device=values.device)
    return torch.nanquantile(values, qt, dim=0)


class QuantileAssessment(NamedTuple):
    """Percentile summary of a batched study over its CONVERGED scenarios
    (``hpfx.studies.QuantileAssessment``): ``thd_q`` (Q, n) THD_F
    quantiles, ``vh_pct_q`` (Q, H-1, n) individual harmonics in % of the
    fundamental, ``v1_q`` (Q, n) fundamental magnitudes, ``exceed_prob``
    (n,) P(THD_F > limit | converged), the worst bus at the 95th
    percentile (the highest quantile if 0.95 is not probed), and the
    converged fraction and sample count."""
    quantiles: Tuple[float, ...]
    harmonics: Tuple[int, ...]
    thd_q: torch.Tensor
    vh_pct_q: torch.Tensor
    v1_q: torch.Tensor
    exceed_prob: torch.Tensor
    worst_bus: int
    converged_frac: float
    n_samples: int


def assess_quantiles(net: Network, devices, settings: Settings,
                     scenarios: Scenarios, *,
                     quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                     thd_limit: float = 0.08,
                     sweep=None) -> QuantileAssessment:
    """Solve the batch (``sweep``, default :func:`hpf_sweep`) and reduce
    THD, individual harmonics and the fundamental to the requested
    quantiles per bus (the IEC 61000-3-6 assessment shape)."""
    run = sweep if sweep is not None else hpf_sweep
    res = run(net, devices, settings, scenarios)
    return summarize_quantiles(res, settings, quantiles=quantiles,
                               thd_limit=thd_limit)


def summarize_quantiles(result: HPFResult, settings: Settings, *,
                        quantiles: Sequence[float] = (0.5, 0.95, 0.99),
                        thd_limit: float = 0.08) -> QuantileAssessment:
    """The quantile reduction of an already solved batched result."""
    qs = tuple(float(v) for v in np.asarray(quantiles))
    ratio_pct, thd_pct = _distortion_pct(result.V_m)   # (B,H-1,n), (B,n)
    thd = thd_pct / 100.0
    conv = result.converged.to(torch.bool)

    thd_q = _quantiles(_masked_rows(thd, conv), qs)
    vh_q = _quantiles(_masked_rows(ratio_pct, conv), qs)
    v1_q = _quantiles(_masked_rows(result.V_m[:, 0, :], conv), qs)

    n_conv = torch.clamp_min(conv.to(thd.dtype).sum(), 1.0)
    exceed = ((thd > thd_limit) & conv[:, None]).to(thd.dtype).sum(
        dim=0) / n_conv

    pick = qs.index(0.95) if 0.95 in qs else len(qs) - 1
    return QuantileAssessment(
        quantiles=qs, harmonics=tuple(settings.harmonics[1:]),
        thd_q=thd_q, vh_pct_q=vh_q, v1_q=v1_q, exceed_prob=exceed,
        worst_bus=int(thd_q[pick].argmax()),
        converged_frac=float(conv.to(thd.dtype).mean()),
        n_samples=int(conv.shape[0]))


def metric_quantiles(result: HPFResult, settings: Settings, metric, *,
                     quantiles: Sequence[float] = (0.5, 0.95, 0.99)):
    """Quantiles (Q, ...) over the converged scenarios of any
    per-scenario ``metric(V_m (H, n), V_a (H, n))``, vectorized over the
    batch by ``torch.func.vmap``."""
    vals = torch.func.vmap(metric)(result.V_m, result.V_a)
    qs = tuple(float(v) for v in np.asarray(quantiles))
    return _quantiles(_masked_rows(vals, result.converged), qs)


class PlanningLevelReport(NamedTuple):
    """Per-order planning-level check of an assessed percentile
    (``hpfx.studies.PlanningLevelReport``): the applied limits (%), the
    margins (H-1, n) (negative exceeds), ``compliant`` and the tightest
    (order, bus)."""
    harmonics: Tuple[int, ...]
    levels_pct: torch.Tensor
    margin_pct: torch.Tensor
    compliant: bool
    binding_order: int
    binding_bus: int


def check_planning_levels(assessment: QuantileAssessment,
                          levels: Optional[Dict[int, float]] = None, *,
                          quantile: float = 0.95,
                          default_pct: float = 3.0) -> PlanningLevelReport:
    """Compare an assessed harmonic percentile against per-order planning
    levels ``{order: limit_pct}`` (orders not listed take
    ``default_pct``); ``quantile`` must be one of the assessment's."""
    qs = assessment.quantiles
    if quantile not in qs:
        raise ValueError(f"quantile {quantile} not among the assessed "
                         f"quantiles {qs} — re-run assess_quantiles with it")
    vh = assessment.vh_pct_q[qs.index(quantile)]          # (H-1, n)
    orders = assessment.harmonics
    lv = np.full(len(orders), float(default_pct))
    for h, pct in (levels or {}).items():
        if int(h) not in orders:
            raise ValueError(f"planning level for order {h} but the "
                             f"assessment covers {orders}")
        lv[orders.index(int(h))] = float(pct)
    lv = torch.as_tensor(lv, dtype=vh.dtype, device=vh.device)
    margin = lv[:, None] - vh                              # (H-1, n)
    bind_o, bind_b = divmod(int(margin.argmin()), margin.shape[1])
    return PlanningLevelReport(
        harmonics=orders, levels_pct=lv, margin_pct=margin,
        compliant=bool((margin >= 0.0).all()),
        binding_order=orders[bind_o], binding_bus=int(bind_b))


def profile_scenarios(settings: Settings, p_profile, *, q_profile=None,
                      inj_profile=None, device=None) -> Scenarios:
    """Scenarios whose batch axis is TIME: step t carries the multipliers
    ``*_profile[t]`` ((T,) or (T, n) / (T, n_nl)); ``q_profile`` defaults
    to ``p_profile``, ``inj_profile`` to 1.  On ``device`` (default: the
    CUDA card) in the settings' dtype."""
    rd, dv = settings.real_dtype, resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=rd, device=dv)
    p = t(p_profile)
    q = p if q_profile is None else t(q_profile)
    inj = None if inj_profile is None else t(inj_profile)
    if q.shape[0] != p.shape[0] or (inj is not None
                                    and inj.shape[0] != p.shape[0]):
        raise ValueError("profiles disagree on the number of time steps")
    return Scenarios(p_scale=p, q_scale=q, injection_scale=inj)


def _concat(parts):
    """Batch-major results (or their FundResult) joined along the batch
    axis, field by field; a field that is None stays None."""
    first = parts[0]
    out = []
    for i, field in enumerate(first):
        if field is None:
            out.append(None)
        elif isinstance(field, FundResult):
            out.append(_concat([p[i] for p in parts]))
        else:
            out.append(torch.cat([p[i] for p in parts], dim=0))
    return type(first)(*out)


def run_timeseries(net: Network, devices, settings: Settings,
                   p_profile, *, q_profile=None, inj_profile=None,
                   chunk: Optional[int] = None, sweep=None) -> HPFResult:
    """Quasi-static time series: one harmonic power flow per profile step,
    the steps solved as one batch (``chunk`` bounds a batch for long
    profiles; the chunks' results are joined field by field).  The
    profiles go to the network's device; the result carries the time
    axis first, for :func:`percentile_compliance` and
    :func:`summarize_quantiles`."""
    scen = profile_scenarios(settings, p_profile, q_profile=q_profile,
                             inj_profile=inj_profile, device=net.device)
    run = sweep if sweep is not None else hpf_sweep
    T = scen.batch
    if chunk is None or chunk >= T:
        return run(net, devices, settings, scen)
    parts = []
    for t0 in range(0, T, chunk):
        sub = Scenarios(*(None if x is None else x[t0:t0 + chunk]
                          for x in scen))
        parts.append(run(net, devices, settings, sub))
    return _concat(parts)


class PercentileComplianceReport(NamedTuple):
    """IEEE-519-style screen of the ``percentile``-th values over a
    window (``hpfx.studies.PercentileComplianceReport``): the percentile
    values (``vh_p`` (H-1, n) %, ``thd_p`` (n,) %), the limits,
    ``compliant``, the fraction of converged steps over either limit per
    bus, and the converged fraction."""
    harmonics: Tuple[int, ...]
    vh_p: torch.Tensor
    thd_p: torch.Tensor
    limit_individual: float
    limit_thd: float
    compliant: bool
    frac_steps_over: torch.Tensor
    converged_frac: float


def percentile_compliance(result: HPFResult, settings: Settings, *,
                          percentile: float = 95.0,
                          v_kv: Optional[float] = None
                          ) -> PercentileComplianceReport:
    """The ``percentile``-th per-bus distortion of a batched result
    against IEEE 519-2014 Table 1 (class from ``v_kv``), non-converged
    steps excluded."""
    ind, thd_lim = _limits_for(v_kv, settings)
    ratio_pct, thd_pct = _distortion_pct(result.V_m)
    conv = result.converged.to(torch.bool)

    p = percentile / 100.0
    vh_p = _quantiles(_masked_rows(ratio_pct, conv), p)
    thd_p = _quantiles(_masked_rows(thd_pct, conv), p)

    over = (ratio_pct.amax(dim=1) > ind) | (thd_pct > thd_lim)
    n_conv = torch.clamp_min(conv.to(thd_pct.dtype).sum(), 1.0)
    frac_over = (over & conv[:, None]).to(thd_pct.dtype).sum(dim=0) / n_conv
    return PercentileComplianceReport(
        harmonics=tuple(settings.harmonics[1:]),
        vh_p=vh_p, thd_p=thd_p,
        limit_individual=ind, limit_thd=thd_lim,
        compliant=bool((vh_p <= ind).all() & (thd_p <= thd_lim).all()),
        frac_steps_over=frac_over,
        converged_frac=float(conv.to(thd_pct.dtype).mean()))


def daily_profile(T: int = 96, *, base: float = 0.7, peak: float = 1.15,
                  peak_hour: float = 19.0, width_h: float = 3.5,
                  dtype=torch.float64, device=None) -> torch.Tensor:
    """Synthetic daily load profile (T steps over 24 h): a ``base``
    plateau with a Gaussian evening peak, computed in float64 as the JAX
    package computes it, then cast to ``dtype`` on ``device`` (default:
    the CUDA card)."""
    t_h = np.arange(T) * (24.0 / T)
    prof = base + (peak - base) * np.exp(
        -0.5 * ((t_h - peak_hour) / width_h) ** 2)
    return torch.tensor(prof, dtype=dtype, device=resolve_device(device))
