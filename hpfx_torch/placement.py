"""Shunt-filter placement screening and greedy bank planning (the port of
:mod:`hpfx.placement`).

The planning question is *where* to put a filter and *which* standard
design to use: a discrete grid of (bus, tuned order, capacitor size)
candidates, each needing a full harmonic power flow.  A shunt filter only
touches the Ybus diagonal, so every candidate is a ``Y_diag`` fold
(:func:`hpfx_torch.harmonic.hpf`'s channel), and the whole screen is one
batch: each candidate's ``(Y, lineY, lineY_f)`` triple is stacked on a
leading K axis and the K candidates go through the batch-major sweep in
one call, as the contingency screen sends its outages.
:func:`plan_filter_bank` chains screens greedily: install the best
candidate, re-screen the remainder.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import Settings
from .cx import Cx
from .harmonic import hpf
from .impedance import (ctype_filter_admittance, highpass_filter_admittance,
                        tuned_filter_admittance)
from .network import Network
from .results import get_thd
from .ybus import build_ybus, line_ybus_pair

__all__ = ["PlacementReport", "FilterPlan", "dominant_orders",
           "screen_filter_placement", "plan_filter_bank",
           "filter_ydiag"]

_TOPOLOGIES = {
    "tuned": tuned_filter_admittance,
    "highpass": highpass_filter_admittance,
    "ctype": ctype_filter_admittance,
}


class PlacementReport(NamedTuple):
    """Ranked outcome of :func:`screen_filter_placement` (K candidates),
    numpy arrays.

    ``order`` ranks candidates best-first: accepted candidates sorted by
    ``objective`` ascending, then rejected ones (non-converged or outside
    the fundamental-voltage window) in original order.  ``q_fund`` is the
    fundamental reactive power the branch supplies (positive =
    capacitive); ``i_rms_ratio`` = branch I_rms/I_1."""
    bus: np.ndarray            # (K,) int
    h_tune: np.ndarray         # (K,) tuned/corner order
    x_cap: np.ndarray          # (K,) fundamental capacitive reactance [pu]
    topology: str
    converged: np.ndarray      # (K,) bool
    accepted: np.ndarray       # (K,) bool: converged AND v-window
    objective: np.ndarray      # (K,) screened objective (default worst THD)
    thd_worst: np.ndarray      # (K,) worst-bus THD_F with the filter
    thd_at_bus: np.ndarray     # (K,) THD_F at the filter bus
    base_objective: float
    base_thd_worst: float
    v1_bus: np.ndarray         # (K,) fundamental |V| at the filter bus
    q_fund: np.ndarray         # (K,) fundamental vars supplied [pu]
    i_rms_ratio: np.ndarray    # (K,) branch I_rms / I_fund
    order: np.ndarray          # (K,) candidate indices, best first

    @property
    def best(self) -> int:
        """Index of the best *accepted* candidate (raises if none)."""
        i = int(self.order[0])
        if not bool(self.accepted[i]):
            raise ValueError("no accepted candidate in this screen")
        return i


def filter_ydiag(net: Network, settings: Settings, bus, h_tune, x_cap,
                 quality: float = 30.0, topology: str = "tuned") -> Cx:
    """Per-bus diagonal admittance (H, n) of shunt filter branch(es), on
    the net's device: the ``Y_diag`` override installing them into any
    solver entry point.  Scalars give one branch; length-K arrays a bank
    (summed per bus)."""
    fn = _TOPOLOGIES[topology]
    rd, dv = settings.real_dtype, net.device
    t = lambda x, dt=rd: torch.atleast_1d(torch.as_tensor(x, dtype=dt,
                                                          device=dv))
    bus = t(bus, torch.long)
    y = fn(settings, t(h_tune), t(x_cap), quality)                 # (K, H)
    onehot = (bus[:, None] == torch.arange(net.n, device=dv)).to(rd)
    return Cx(torch.einsum("kh,kn->hn", y.re, onehot),
              torch.einsum("kh,kn->hn", y.im, onehot))


def dominant_orders(net: Network, devices, settings: Settings,
                    k: int = 3, base=None) -> np.ndarray:
    """The ``k`` harmonic orders with the largest base-case voltage
    distortion (max over buses of |V_h|), the natural tuning targets.
    ``base``: a pre-solved base-case HPFResult."""
    if base is None:
        base = hpf(net, devices, settings)
    vm = base.V_m.cpu().numpy()                 # (H, n)
    worst = vm[1:].max(axis=1)                  # skip the fundamental
    orders = np.asarray(settings.harmonics[1:])
    top = np.argsort(worst)[::-1][:k]
    return np.sort(orders[top])


def _candidate_ybus(net: Network, settings: Settings, yd: Cx):
    """The ``(Y, lineY, lineY_f)`` triple of every candidate, stacked on a
    leading K axis: the network's admittances with ``yd`` (K, H, n)
    folded into the diagonal (and into the line structure's diagonal
    terms), as :func:`hpfx_torch.harmonic.hpf` folds a ``Y_diag``."""
    Y0 = build_ybus(net, settings)
    Y = Cx(Y0.re + torch.diag_embed(yd.re), Y0.im + torch.diag_embed(yd.im))
    lineY, lineY_f = line_ybus_pair(net, settings)
    if lineY is None:
        return Y, None, None
    K = yd.shape[0]
    each = lambda c: Cx(c.re.expand((K,) + c.re.shape),
                        c.im.expand((K,) + c.im.shape))
    return (Y, lineY._replace(Ys=each(lineY.Ys), d=lineY.d + yd),
            lineY_f._replace(Ys=each(lineY_f.Ys), d=lineY_f.d + yd[:, :1]))


def _default_objective(V_m, V_a):
    return float(get_thd(torch.as_tensor(V_m)).THD_F.max())


def screen_filter_placement(
    net: Network, devices, settings: Settings, *,
    buses: Optional[Sequence[int]] = None,
    h_tunes: Optional[Sequence[float]] = None,
    x_caps: Sequence[float] = (0.5, 1.0, 2.0),
    quality: float = 30.0, topology: str = "tuned", detune: float = 0.97,
    objective: Optional[Callable] = None,
    v_limits=(0.5, 2.0), Y_diag: Optional[Cx] = None,
) -> PlacementReport:
    """Screen every (bus, h_tune, x_cap) candidate with one batched full
    HPF and rank by ``objective`` (default: worst-bus THD_F)
    (``hpfx.placement.screen_filter_placement``).

    Defaults: ``buses`` = every non-slack bus; ``h_tunes`` = the three
    :func:`dominant_orders` of the base case times ``detune``.
    ``objective(V_m, V_a) -> scalar`` is evaluated on the host on each
    candidate's solved (H, n) state, as numpy arrays.  ``v_limits``: a
    candidate whose fundamental voltage leaves the window at ANY bus is
    rejected (the pure-THD objective's degenerate minimum at voltage
    collapse).  ``Y_diag``: pre-existing per-bus diagonal admittance
    (H, n), added to every candidate AND the base case.
    """
    from .solve import Scenarios, _hpf_sweep_vmap

    if topology not in _TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}: "
                         f"use one of {sorted(_TOPOLOGIES)}")
    rd, dv = settings.real_dtype, net.device
    base = hpf(net, devices, settings, Y_diag=Y_diag)
    if buses is None:
        buses = list(range(1, net.n))
    if h_tunes is None:
        h_tunes = detune * dominant_orders(net, devices, settings,
                                           base=base)
    bus_g, ht_g, xc_g = (a.ravel() for a in np.meshgrid(
        np.asarray(buses, np.int32), np.asarray(h_tunes, np.float64),
        np.asarray(x_caps, np.float64), indexing="ij"))
    K = bus_g.size

    t = lambda a: torch.as_tensor(a, dtype=rd, device=dv)
    y_f = _TOPOLOGIES[topology](settings, t(ht_g), t(xc_g), quality)  # (K, H)
    onehot = (torch.as_tensor(bus_g, device=dv)[:, None]
              == torch.arange(net.n, device=dv)).to(rd)              # (K, n)
    yd = Cx(y_f.re[:, :, None] * onehot[:, None, :],
            y_f.im[:, :, None] * onehot[:, None, :])                 # (K, H, n)
    if Y_diag is not None:
        yd = Cx(yd.re + Y_diag.re, yd.im + Y_diag.im)

    res = _hpf_sweep_vmap(net, devices, settings,
                          Scenarios(p_scale=torch.ones(K, dtype=rd,
                                                       device=dv)),
                          Y=_candidate_ybus(net, settings, yd))
    conv = res.converged.cpu().numpy()
    V_m, V_a = res.V_m.cpu().numpy(), res.V_a.cpu().numpy()    # (K, H, n)

    # duty at the branch: I(h) = y_f(h) · V(h, bus)
    vm_bus = V_m[np.arange(K), :, bus_g]                       # (K, H)
    i_mag = y_f.abs().cpu().numpy() * vm_bus
    i1 = np.maximum(i_mag[:, 0], 1e-30)
    i_rms_ratio = np.sqrt((i_mag ** 2).sum(axis=1)) / i1
    q_fund = vm_bus[:, 0] ** 2 * y_f.im[:, 0].cpu().numpy()

    if objective is None:
        objective = _default_objective
    obj = np.array([objective(V_m[k], V_a[k]) for k in range(K)])
    thd = get_thd(torch.as_tensor(V_m).movedim(1, 0)).THD_F.numpy()  # (K, n)
    accepted = conv.copy()
    if v_limits is not None:
        v1 = V_m[:, 0, :]                                      # (K, n)
        accepted &= (v1 >= v_limits[0]).all(axis=1) \
            & (v1 <= v_limits[1]).all(axis=1)

    # rank: accepted by objective ascending, then the rejects
    key = np.where(accepted, obj, np.inf)
    order = np.argsort(key, kind="stable")
    base_thd = get_thd(base.V_m).THD_F.cpu().numpy()
    return PlacementReport(
        bus=bus_g, h_tune=ht_g, x_cap=xc_g, topology=topology,
        converged=conv, accepted=accepted, objective=obj,
        thd_worst=thd.max(axis=1), thd_at_bus=thd[np.arange(K), bus_g],
        base_objective=objective(base.V_m.cpu().numpy(),
                                 base.V_a.cpu().numpy()),
        base_thd_worst=float(base_thd.max()),
        v1_bus=V_m[np.arange(K), 0, bus_g],
        q_fund=q_fund, i_rms_ratio=i_rms_ratio, order=order)


class FilterPlan(NamedTuple):
    """Outcome of :func:`plan_filter_bank`: the greedily chosen branches
    (parallel arrays, one entry per installed filter), the objective
    trajectory (``history[0]`` = unmitigated), the cumulative ``Y_diag``
    installing the whole bank, and the per-stage PlacementReports."""
    buses: np.ndarray
    h_tunes: np.ndarray
    x_caps: np.ndarray
    topology: str
    history: np.ndarray        # (n_installed + 1,)
    Y_diag: Optional[Cx]
    reports: tuple


def plan_filter_bank(net: Network, devices, settings: Settings, *,
                     n_filters: int = 2, target: Optional[float] = None,
                     Y_diag: Optional[Cx] = None,
                     **screen_kw) -> FilterPlan:
    """Greedy multi-filter placement: screen, install the winner, rescreen
    (``hpfx.placement.plan_filter_bank``).  Stops early once ``objective
    <= target`` or when no accepted candidate improves on the current
    state.  ``screen_kw`` is forwarded to :func:`screen_filter_placement`.
    """
    topology = screen_kw.get("topology", "tuned")
    quality = screen_kw.get("quality", 30.0)
    sel_b, sel_h, sel_x, reports = [], [], [], []
    history = None
    for _ in range(n_filters):
        rep = screen_filter_placement(net, devices, settings,
                                      Y_diag=Y_diag, **screen_kw)
        if history is None:
            history = [rep.base_objective]
        if target is not None and history[-1] <= target:
            break
        i = int(rep.order[0])
        if not bool(rep.accepted[i]) or rep.objective[i] >= history[-1]:
            break                     # nothing accepted improves
        reports.append(rep)
        sel_b.append(int(rep.bus[i]))
        sel_h.append(float(rep.h_tune[i]))
        sel_x.append(float(rep.x_cap[i]))
        history.append(float(rep.objective[i]))
        branch = filter_ydiag(net, settings, rep.bus[i], rep.h_tune[i],
                              rep.x_cap[i], quality, topology)
        Y_diag = branch if Y_diag is None else Cx(Y_diag.re + branch.re,
                                                  Y_diag.im + branch.im)
    if history is None:               # n_filters == 0
        rep = screen_filter_placement(net, devices, settings,
                                      Y_diag=Y_diag, **screen_kw)
        history = [rep.base_objective]
    return FilterPlan(buses=np.asarray(sel_b, np.int32),
                      h_tunes=np.asarray(sel_h), x_caps=np.asarray(sel_x),
                      topology=topology, history=np.asarray(history),
                      Y_diag=Y_diag, reports=tuple(reports))
