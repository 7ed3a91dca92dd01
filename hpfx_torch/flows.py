"""Per-line harmonic power flows, losses, and the distortion standards:
the port of :mod:`hpfx.flows`.

- :func:`line_flows`: per-line, per-harmonic split-complex currents and
  powers at both ends of the pi/tap/shift branch model that
  ``build_ybus`` stamps, with series and shunt-G losses;
- :func:`check_ieee519` / :func:`ieee519_screen`: IEEE Std 519-2014
  Table 1 voltage limits on one solved case / a batched sweep;
- :func:`check_ieee519_current` and :func:`k_factor`: Table 2's current
  limits and the IEEE C57.110 K-factor of a branch current;
- :func:`power_indices` / :func:`line_power_indices`: the IEEE 1459
  power decomposition;
- :func:`check_en50160` / :func:`en50160_screen`: EN 50160's per-order
  voltage limits.

Everything follows the device and dtype of its input tensors; only
:func:`en50160_limit_vector` builds a tensor from nothing and takes
``device=`` (default: the CUDA card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cx
from ._device import resolve_device
from .config import Settings
from .cx import Cx
from .network import Network
from .results import get_thd

__all__ = ["LineFlows", "line_flows", "IEEE519Report", "check_ieee519",
           "IEEE519_LIMITS", "IEEE519Summary", "ieee519_screen",
           "k_factor", "IEEE519_CURRENT_LIMITS", "IEEE519CurrentReport",
           "check_ieee519_current", "EN50160_LIMITS", "EN50160_THD_LIMIT",
           "EN50160Report", "check_en50160", "en50160_screen",
           "en50160_limit_vector", "PowerIndices", "power_indices",
           "line_power_indices"]


class LineFlows(NamedTuple):
    """Per-line harmonic flow quantities, all (H, L) unless noted
    (``hpfx.flows.LineFlows``): ``I_f``/``I_t`` split-complex branch
    currents INTO the line at each end, the complex power entering it at
    each end, the per-line real ``loss`` and the scalar ``total_loss``."""
    I_f: Cx
    I_t: Cx
    P_f: torch.Tensor
    Q_f: torch.Tensor
    P_t: torch.Tensor
    Q_t: torch.Tensor
    loss: torch.Tensor
    total_loss: torch.Tensor


def line_flows(net: Network, settings: Settings, V_m, V_a) -> LineFlows:
    """Branch currents, powers and losses of a solved (H, n) voltage
    solution, from the same series/tap/phase/pi-shunt algebra that
    ``build_ybus`` stamps (the physical shunt placement, whatever
    ``compat_shunt_bug`` says)."""
    rd = settings.real_dtype
    h = torch.tensor(settings.harmonics, dtype=rd,
                     device=net.device)[:, None]                 # (H, 1)
    R, X = net.line_R, net.line_X
    Xh = X * h
    d = R * R + Xh * Xh
    Ys = Cx(R / d, -Xh / d)
    tau = net.line_tau
    inv_t_ft = cx.expj(net.line_shift) * (1.0 / tau)
    inv_t_tf = cx.expj(-net.line_shift) * (1.0 / tau)
    Ysh = Cx((net.line_G / 2.0).expand(Xh.shape), h * net.line_B / 2.0)

    f, t = net.line_from, net.line_to
    V = cx.polar(torch.as_tensor(V_m, dtype=rd, device=net.device),
                 torch.as_tensor(V_a, dtype=rd, device=net.device))
    V_f, V_t = V[:, f], V[:, t]                                  # (H, L)

    I_f = (Ys * (1.0 / (tau * tau)) + Ysh * (1.0 / (tau * tau))) * V_f \
        - (Ys * inv_t_ft) * V_t
    I_t = (Ys + Ysh) * V_t - (Ys * inv_t_tf) * V_f

    S_f = V_f * I_f.conj()
    S_t = V_t * I_t.conj()
    loss = S_f.re + S_t.re
    return LineFlows(I_f=I_f, I_t=I_t,
                     P_f=S_f.re, Q_f=S_f.im, P_t=S_t.re, Q_t=S_t.im,
                     loss=loss, total_loss=loss.sum())


#: IEEE Std 519-2014 Table 1 — voltage distortion limits at the PCC by
#: bus voltage class: (upper kV, individual harmonic %, THD %)
IEEE519_LIMITS = (
    (1.0, 5.0, 8.0),        # V <= 1 kV
    (69.0, 3.0, 5.0),       # 1 kV < V <= 69 kV
    (161.0, 1.5, 2.5),      # 69 kV < V <= 161 kV
    (float("inf"), 1.0, 1.5),
)


def _limits_for(v_kv: float, settings: Settings):
    """(individual %, THD %) for the PCC voltage class; ``v_kv=None``
    takes the per-unit system's base voltage."""
    if v_kv is None:
        v_kv = settings.base_voltage / 1e3
    for vmax, ind, thd_lim in IEEE519_LIMITS:
        if v_kv <= vmax:
            return ind, thd_lim
    raise AssertionError("unreachable: IEEE519_LIMITS ends with inf")


def _distortion_pct(V_m):
    """(individual ratios (..., H-1, n) in %, THD_F (..., n) in %) of
    (..., H, n) magnitudes; leading axes are scenarios."""
    thd = get_thd(V_m.movedim(-2, 0)).THD_F
    return 100.0 * V_m[..., 1:, :] / V_m[..., :1, :], 100.0 * thd


def _orders(settings: Settings, device) -> torch.Tensor:
    return torch.tensor(settings.harmonics[1:], device=device)


class IEEE519Report(NamedTuple):
    """Per-bus IEEE-519 voltage-distortion check (``hpfx.flows.
    IEEE519Report``): ``ratio`` (H-1, n) in %, the binding order per bus,
    THD_F in %, the class limits and ``compliant``."""
    harmonics: tuple
    ratio: torch.Tensor
    worst_ratio: torch.Tensor
    worst_order: torch.Tensor
    thd: torch.Tensor
    limit_individual: float
    limit_thd: float
    compliant: torch.Tensor


def check_ieee519(result, settings: Settings,
                  v_kv: float = None) -> IEEE519Report:
    """Check a solved case against IEEE Std 519-2014 Table 1, one voltage
    class (``v_kv``, default the base voltage) for every bus."""
    ind, thd_lim = _limits_for(v_kv, settings)
    ratio, thd = _distortion_pct(result.V_m)                  # (H-1, n)
    worst_ratio, worst = ratio.max(dim=0)
    compliant = (worst_ratio <= ind) & (thd <= thd_lim)
    return IEEE519Report(
        harmonics=tuple(settings.harmonics[1:]),
        ratio=ratio, worst_ratio=worst_ratio,
        worst_order=_orders(settings, ratio.device)[ratio.argmax(dim=0)],
        thd=thd, limit_individual=ind, limit_thd=thd_lim,
        compliant=compliant)


class IEEE519Summary(NamedTuple):
    """Batched IEEE-519 screen over a sweep, (B,) leaves
    (``hpfx.flows.IEEE519Summary``): ``compliant`` is masked by
    convergence, ``frac_violating`` counts converged scenarios that
    violate either limit."""
    worst_ratio: torch.Tensor    # worst V_h/V_1 in % over buses+orders
    thd: torch.Tensor            # worst-bus THD_F in %
    compliant: torch.Tensor      # bool, converged AND both limits pass
    frac_violating: torch.Tensor  # scalar, among converged scenarios


def _screen(worst, thd, ok, converged) -> IEEE519Summary:
    ok = ok & converged
    viol = (~ok) & converged
    denom = torch.clamp_min(converged.to(worst.dtype).sum(), 1.0)
    return IEEE519Summary(worst_ratio=worst, thd=thd, compliant=ok,
                          frac_violating=viol.to(worst.dtype).sum() / denom)


def ieee519_screen(result, settings: Settings,
                   v_kv: float = None) -> IEEE519Summary:
    """:func:`check_ieee519`'s limits on a whole batched sweep result
    (``hpfx.flows.ieee519_screen``)."""
    ind, thd_lim = _limits_for(v_kv, settings)
    ratio, thd_bus = _distortion_pct(result.V_m)
    worst = ratio.amax(dim=(-2, -1))
    thd = thd_bus.amax(dim=-1)
    return _screen(worst, thd, (worst <= ind) & (thd <= thd_lim),
                   result.converged)


class PowerIndices(NamedTuple):
    """IEEE Std 1459-2010 single-phase power decomposition
    (``hpfx.flows.PowerIndices``); leaves share the trailing shape of the
    inputs, powers in pu."""
    P: torch.Tensor
    P1: torch.Tensor
    P_H: torch.Tensor
    Q1: torch.Tensor
    S: torch.Tensor
    S1: torch.Tensor
    S_H: torch.Tensor
    D_I: torch.Tensor
    D_V: torch.Tensor
    D_H: torch.Tensor
    N: torch.Tensor
    pf: torch.Tensor
    dpf: torch.Tensor
    thd_v: torch.Tensor
    thd_i: torch.Tensor


def power_indices(V: Cx, I: Cx) -> PowerIndices:
    """IEEE 1459 decomposition of per-harmonic split-complex phasors with
    the harmonic axis first ((H, ...))."""
    s_h = V * I.conj()
    P1, Q1 = s_h.re[0], s_h.im[0]
    P = s_h.re.sum(dim=0)
    P_H = P - P1
    v2, i2 = V.abs2(), I.abs2()
    eps = torch.finfo(v2.dtype).tiny
    V1, I1 = torch.sqrt(v2[0]), torch.sqrt(i2[0])
    V_H = torch.sqrt(v2[1:].sum(dim=0))
    I_H = torch.sqrt(i2[1:].sum(dim=0))
    S1 = V1 * I1
    S_H = V_H * I_H
    S = torch.sqrt(v2.sum(dim=0) * i2.sum(dim=0))
    # clamp the differences of squares against rounding
    N = torch.sqrt(torch.clamp_min(S * S - P * P, 0.0))
    D_H = torch.sqrt(torch.clamp_min(S_H * S_H - P_H * P_H, 0.0))
    return PowerIndices(P=P, P1=P1, P_H=P_H, Q1=Q1, S=S, S1=S1, S_H=S_H,
                        D_I=V1 * I_H, D_V=V_H * I1, D_H=D_H, N=N,
                        pf=P / torch.clamp_min(S, eps),
                        dpf=P1 / torch.clamp_min(S1, eps),
                        thd_v=V_H / torch.clamp_min(V1, eps),
                        thd_i=I_H / torch.clamp_min(I1, eps))


def line_power_indices(net: Network, settings: Settings, V_m, V_a,
                       side: str = "from") -> PowerIndices:
    """IEEE 1459 indices of every line terminal ((L,) leaves), metered
    at the ``"from"`` or ``"to"`` end, current INTO the branch."""
    if side not in ("from", "to"):
        raise ValueError(f"unknown side {side!r}: use 'from' or 'to'")
    fl = line_flows(net, settings, V_m, V_a)
    rd = settings.real_dtype
    V = cx.polar(torch.as_tensor(V_m, dtype=rd, device=net.device),
                 torch.as_tensor(V_a, dtype=rd, device=net.device))
    bus = net.line_from if side == "from" else net.line_to
    I = fl.I_f if side == "from" else fl.I_t
    return power_indices(Cx(V.re[:, bus], V.im[:, bus]), I)


def k_factor(I_m: torch.Tensor, harmonics) -> torch.Tensor:
    """IEEE C57.110 transformer K-factor of (H, ...) harmonic current
    magnitudes, sum (I_h h)² / sum I_h²; the trailing shape."""
    h = torch.as_tensor(harmonics, dtype=I_m.dtype, device=I_m.device)
    h = h.reshape((-1,) + (1,) * (I_m.dim() - 1))
    w = I_m * I_m
    return (w * h * h).sum(dim=0) / torch.clamp_min(
        w.sum(dim=0), torch.finfo(I_m.dtype).tiny)


#: IEEE Std 519-2014 Table 2 — current distortion limits at the PCC
#: (120 V..69 kV) by short-circuit ratio Isc/IL: (max Isc/IL, odd-order
#: limits % for h<11, 11<=h<17, 17<=h<23, 23<=h<35, 35<=h<=50, TDD %);
#: even orders at 25% of the odd limit
IEEE519_CURRENT_LIMITS = (
    (20.0, 4.0, 2.0, 1.5, 0.6, 0.3, 5.0),
    (50.0, 7.0, 3.5, 2.5, 1.0, 0.5, 8.0),
    (100.0, 10.0, 4.5, 4.0, 1.5, 0.7, 12.0),
    (1000.0, 12.0, 5.5, 5.0, 2.0, 1.0, 15.0),
    (float("inf"), 15.0, 7.0, 6.0, 2.5, 1.4, 20.0),
)


class IEEE519CurrentReport(NamedTuple):
    """IEEE-519 Table 2 check of ONE branch current
    (``hpfx.flows.IEEE519CurrentReport``)."""
    harmonics: tuple
    ratio: torch.Tensor
    limits: torch.Tensor
    tdd: torch.Tensor
    limit_tdd: float
    compliant: torch.Tensor


def check_ieee519_current(I_m: torch.Tensor, harmonics, isc_over_il: float,
                          i_load: float = None) -> IEEE519CurrentReport:
    """Check one (H,) branch current spectrum against IEEE Std 519-2014
    Table 2; ``i_load`` (default: the fundamental of ``I_m``) normalizes
    the ratios."""
    for row in IEEE519_CURRENT_LIMITS:
        if isc_over_il <= row[0]:
            break
    _, l11, l17, l23, l35, l50, tdd_lim = row
    hs = tuple(int(x) for x in harmonics)
    i_l = I_m[0] if i_load is None else i_load

    def order_limit(h):
        base = (l11 if h < 11 else l17 if h < 17 else l23 if h < 23
                else l35 if h < 35 else l50)
        return base if h % 2 == 1 else 0.25 * base

    limits = torch.tensor([order_limit(h) for h in hs[1:]],
                          dtype=I_m.dtype, device=I_m.device)
    ratio = 100.0 * I_m[1:] / i_l
    tdd = 100.0 * torch.sqrt((I_m[1:] ** 2).sum()) / i_l
    compliant = (ratio <= limits).all() & (tdd <= tdd_lim)
    return IEEE519CurrentReport(
        harmonics=hs[1:], ratio=ratio, limits=limits, tdd=tdd,
        limit_tdd=tdd_lim, compliant=compliant)


#: EN 50160 (and IEC 61000-2-2 LV) individual harmonic voltage limits in %
#: of the fundamental, by order; THD <= 8%.  Orders above 25 have no
#: tabulated value and are unconstrained (limit inf).
EN50160_LIMITS = {
    # odd non-triplen
    5: 6.0, 7: 5.0, 11: 3.5, 13: 3.0, 17: 2.0, 19: 1.5, 23: 1.5, 25: 1.5,
    # odd triplen
    3: 5.0, 9: 1.5, 15: 0.5, 21: 0.5,
    # even
    2: 2.0, 4: 1.0, 6: 0.5, 8: 0.5, 10: 0.5, 12: 0.5, 14: 0.5, 16: 0.5,
    18: 0.5, 20: 0.5, 22: 0.5, 24: 0.5,
}

EN50160_THD_LIMIT = 8.0


def en50160_limit_vector(harmonics, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Per-order limits (%) aligned with ``harmonics[1:]``, +inf past the
    table; on ``device`` (default: the CUDA card)."""
    return torch.tensor([EN50160_LIMITS.get(int(h), float("inf"))
                         for h in tuple(harmonics)[1:]], dtype=dtype,
                        device=resolve_device(device))


class EN50160Report(NamedTuple):
    """Per-bus EN 50160 voltage-quality check
    (``hpfx.flows.EN50160Report``): ``margin`` = limits − ratio (negative
    violates), the binding tabulated order per bus, ``compliant``."""
    harmonics: tuple
    ratio: torch.Tensor
    limits: torch.Tensor
    margin: torch.Tensor
    worst_order: torch.Tensor
    thd: torch.Tensor
    compliant: torch.Tensor


def check_en50160(result, settings: Settings) -> EN50160Report:
    """Check a solved case against EN 50160's per-order voltage limits."""
    ratio, thd = _distortion_pct(result.V_m)                 # (H-1, n)
    limits = en50160_limit_vector(settings.harmonics, ratio.dtype,
                                  ratio.device)
    margin = limits[:, None] - ratio
    tab = torch.isfinite(limits)
    # untabulated rows never bind: +inf margin for the argmin
    margin_t = torch.where(tab[:, None], margin,
                           torch.full_like(margin, float("inf")))
    worst = margin_t.argmin(dim=0)
    compliant = (margin_t >= 0.0).all(dim=0) & (thd <= EN50160_THD_LIMIT)
    return EN50160Report(
        harmonics=tuple(settings.harmonics[1:]), ratio=ratio,
        limits=limits, margin=margin,
        worst_order=_orders(settings, ratio.device)[worst],
        thd=thd, compliant=compliant)


def en50160_screen(result, settings: Settings) -> IEEE519Summary:
    """Batched EN 50160 screen of a sweep result, an
    :class:`IEEE519Summary` whose ``worst_ratio`` is the worst use of a
    tabulated limit over orders and buses, in % of the limit."""
    ratio, thd_bus = _distortion_pct(result.V_m)
    limits = en50160_limit_vector(settings.harmonics, ratio.dtype,
                                  ratio.device)
    tab = torch.isfinite(limits)[:, None]
    safe = torch.where(tab, limits[:, None], torch.ones_like(limits[:, None]))
    util = torch.where(tab, 100.0 * ratio / safe, torch.zeros_like(ratio))
    worst = util.amax(dim=(-2, -1))
    thd = thd_bus.amax(dim=-1)
    return _screen(worst, thd, (worst <= 100.0) & (thd <= EN50160_THD_LIMIT),
                   result.converged)
