"""Harmonic N-1 contingency screening: line, shunt and device outages
(the port of :mod:`hpfx.contingency`).

An outage batch is a batch axis.  Where the JAX package stacks the
surviving L−1 lines of every outage and vmaps the whole ``hpf``, the
port keeps all L lines in every outage and zeroes the outaged line's
series and shunt admittances (:func:`outage_ybus`): one set of line
endpoints serves every outage, and the per-outage ``(Y, lineY,
lineY_f)`` triples, with a leading batch axis, go through the
batch-major (vmap) layout (``hpfx_torch.solve._hpf_sweep_vmap``) as one
batch.  The (outage × draw) screen (:func:`screen_line_outages_sweep`)
solves its K·S pairs so, in one batch on the device.  Adding a zero
changes no bit, so the zeroed build equals the L−1 build.

Islanding is decided on the host (union-find over the surviving lines)
before anything is solved: an outage that splits the grid is reported
``islanded`` and left out of the batch.

Two defects of the reference are carried over as they are:
:func:`screen_line_outages_sweep` never checks that its intact-network
baseline converged, and :func:`_verify_infeasible_pairs` calls a pair
infeasible after one cold float64 start.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .config import Settings
from .cx import Cx
from .harmonic import hpf
from .network import Network
from .results import get_thd
from .solve import Scenarios, _hpf_sweep_vmap, hpf_sweep
from .ybus import _series, build_line_ybus, build_ybus, line_ybus_pair

_LINE_FIELDS = ("line_from", "line_to", "line_R", "line_X",
                "line_G", "line_B", "line_tau", "line_shift")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def islanded_lines(net: Network) -> np.ndarray:
    """(L,) bool: True where removing that single line disconnects the
    grid (union-find over the surviving lines)."""
    f = _host(net.line_from)
    t = _host(net.line_to)
    L, n = len(f), net.n
    out = np.zeros(L, bool)
    for k in range(L):
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for j in range(L):
            if j != k:
                ra, rb = find(int(f[j])), find(int(t[j]))
                if ra != rb:
                    parent[ra] = rb
        root = find(0)
        out[k] = any(find(i) != root for i in range(n))
    return out


def _stack(parts):
    """Stack a sequence of equal-structured Cx / LineYbus / None along a
    new leading axis (a LineYbus stacks its per-network fields, Ys and
    d, and keeps the shared ones)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, Cx):
        return Cx(torch.stack([p.re for p in parts]),
                  torch.stack([p.im for p in parts]))
    return first._replace(Ys=_stack([p.Ys for p in parts]),
                          d=_stack([p.d for p in parts]))


def outage_ybus(net: Network, settings: Settings, outages: Sequence[int]):
    """The ``(Y, lineY, lineY_f)`` triple of every single-line outage in
    ``outages``, stacked on a leading axis: each keeps all L lines, the
    outaged one with zero series and shunt admittance.  ``lineY`` and
    ``lineY_f`` are None unless ``settings.stable_mismatch``."""
    _, Ys, Ysh = _series(net, settings)
    L = Ys.shape[-1]
    Yk, lines = [], []
    for k in outages:
        keep = torch.ones(L, dtype=Ys.dtype, device=net.device)
        keep[int(k)] = 0.0
        kw = dict(Ys=Ys * keep, Ysh=Ysh * keep)
        Yk.append(build_ybus(net, settings, **kw))
        if settings.stable_mismatch:
            lines.append(build_line_ybus(net, settings, **kw))
    if not settings.stable_mismatch:
        return _stack(Yk), None, None
    lineY = _stack(lines)
    return _stack(Yk), lineY, lineY._replace(Ys=lineY.Ys[..., :1, :],
                                             d=lineY.d[..., :1, :])


def _repeat(Ytriple, S: int):
    """Every network of a stacked triple repeated for S consecutive
    scenarios (pair k·S + s is network k under draw s)."""
    rep = lambda t: t.repeat_interleave(S, dim=0)
    Y, lineY, lineY_f = Ytriple
    Y = Cx(rep(Y.re), rep(Y.im))
    if lineY is None:
        return Y, None, None
    line = lambda l: l._replace(Ys=Cx(rep(l.Ys.re), rep(l.Ys.im)),
                                d=Cx(rep(l.d.re), rep(l.d.im)))
    return Y, line(lineY), line(lineY_f)


def _solve_networks(net: Network, devices, settings: Settings, Ytriple,
                    scenarios: Scenarios):
    """One cold batch-major solve of every (network, draw) pair: the
    stacked triple's K networks crossed with the S draws of
    ``scenarios``.  Returns (converged, n_iter, thd (K, S, n), V_m[0]
    (K, S, n)) as tensors."""
    K, S = Ytriple[0].shape[0], scenarios.batch
    tile = lambda x: None if x is None else x.repeat(
        (K,) + (1,) * (x.dim() - 1))
    res = _hpf_sweep_vmap(net, devices, settings,
                          Scenarios(*(tile(x) for x in scenarios)),
                          Y=_repeat(Ytriple, S))
    thd = get_thd(res.V_m.movedim(1, 0)).THD_F
    shape = lambda x: x.reshape((K, S) + x.shape[1:])
    return (shape(res.converged), shape(res.n_iter), shape(thd),
            shape(res.V_m[:, 0, :]))


def _ones(settings: Settings, B: int, dv) -> Scenarios:
    one = torch.ones((B,), dtype=settings.real_dtype, device=dv)
    return Scenarios(one, one, one)


class ContingencyReport(NamedTuple):
    """Outcome of an N-1 screen (``hpfx.contingency.ContingencyReport``),
    numpy arrays, (K,) unless noted: ``islanded`` rows are not solved
    (NaN/False), ``thd`` (K, n) per-bus THD_F, ``base_thd`` (n,) the
    intact network's, ``worst_thd`` and its increase ``delta_thd``,
    ``v1_min`` the lowest fundamental magnitude, ``ranking`` by
    descending ``delta_thd`` (islanded and non-converged last)."""
    outages: Tuple[int, ...]
    islanded: np.ndarray
    converged: np.ndarray
    n_iter: np.ndarray
    thd: np.ndarray
    base_thd: np.ndarray
    worst_thd: np.ndarray
    delta_thd: np.ndarray
    v1_min: np.ndarray
    ranking: np.ndarray


def _assemble_report(outages, islanded, conv, n_iter, thd, base_thd,
                     v1_min) -> ContingencyReport:
    K, worst_base = len(outages), float(np.max(base_thd))
    solved = ~np.all(np.isnan(thd), axis=1)
    worst = np.full(K, np.nan)
    if solved.any():
        worst[solved] = np.nanmax(thd[solved], axis=1)
    delta = worst - worst_base
    order = np.argsort(np.where(islanded | ~conv, -np.inf, delta))[::-1]
    return ContingencyReport(
        outages=tuple(int(o) for o in outages), islanded=islanded,
        converged=conv, n_iter=n_iter, thd=thd, base_thd=base_thd,
        worst_thd=worst, delta_thd=delta, v1_min=v1_min,
        ranking=order)


def _base_case(net, devices, settings, base=None):
    res = base if base is not None else hpf(net, devices, settings)
    if not bool(res.converged):
        raise ValueError("intact-network HPF did not converge — "
                         "contingency deltas would be meaningless")
    return _host(get_thd(res.V_m).THD_F)


def _line_selection(net: Network, outages):
    L = net.line_from.shape[0]
    sel = list(range(L)) if outages is None else [int(k) for k in outages]
    bad = [k for k in sel if not 0 <= k < L]
    if bad:
        raise ValueError(f"line indices {bad} out of range (0..{L - 1})")
    isl_all = islanded_lines(net)
    islanded = np.asarray([isl_all[k] for k in sel], bool)
    solvable = [k for k, isl in zip(sel, islanded) if not isl]
    return sel, islanded, solvable


def screen_line_outages(net: Network, devices, settings: Settings, *,
                        outages: Optional[Sequence[int]] = None,
                        base=None) -> ContingencyReport:
    """N-1 line-outage screen: the full harmonic power flow on every
    surviving topology in one batch, ranked by how far each outage pushes
    the worst-bus THD.  ``outages``: line indices (default all);
    ``base``: an already solved intact-network result."""
    sel, islanded, solvable = _line_selection(net, outages)
    base_thd = _base_case(net, devices, settings, base)
    K, n = len(sel), net.n
    conv = np.zeros(K, bool)
    n_iter = np.zeros(K, np.int32)
    thd = np.full((K, n), np.nan)
    v1_min = np.full(K, np.nan)
    if solvable:
        c, it, t, v1 = _solve_networks(
            net, devices, settings, outage_ybus(net, settings, solvable),
            _ones(settings, 1, net.device))
        pos = [sel.index(k) for k in solvable]
        conv[pos] = _host(c[:, 0])
        n_iter[pos] = _host(it[:, 0])
        thd[pos] = _host(t[:, 0])
        v1_min[pos] = _host(v1[:, 0].amin(dim=-1))
    return _assemble_report(sel, islanded, conv, n_iter, thd, base_thd,
                            v1_min)


def screen_shunt_outages(net: Network, devices, settings: Settings, *,
                         buses: Optional[Sequence[int]] = None,
                         base=None) -> ContingencyReport:
    """N-1 shunt-outage screen: for each bus with a shunt reactance
    (``X_sh != 0``; ``buses`` defaults to all of them), solve with that
    shunt removed."""
    xsh = _host(net.bus_Xsh)
    sel = [int(b) for b in (buses if buses is not None
                            else np.flatnonzero(xsh != 0.0))]
    bad = [b for b in sel if not 0 <= b < net.n]
    if bad:
        raise ValueError(f"bus indices {bad} out of range (0..{net.n - 1})")
    off = [b for b in sel if xsh[b] == 0.0]
    if off:
        raise ValueError(f"buses {off} carry no shunt (X_sh == 0) — "
                         "nothing to outage")
    base_thd = _base_case(net, devices, settings, base)
    triples = []
    for b in sel:
        row = net.bus_Xsh.clone()
        row[b] = 0.0
        net_b = dataclasses.replace(net, bus_Xsh=row)
        triples.append((build_ybus(net_b, settings),
                        *line_ybus_pair(net_b, settings)))
    c, it, t, v1 = _solve_networks(
        net, devices, settings, tuple(_stack(list(p)) for p in
                                      zip(*triples)),
        _ones(settings, 1, net.device))
    return _assemble_report(
        sel, np.zeros(len(sel), bool), _host(c[:, 0]), _host(it[:, 0]),
        _host(t[:, 0]), base_thd, _host(v1[:, 0].amin(dim=-1)))


def device_outage_scenarios(net: Network, settings: Settings, *,
                            devices_out: Optional[Sequence[int]] = None,
                            device=None
                            ) -> Tuple[Scenarios, Tuple[int, ...]]:
    """Scenarios whose k-th row trips nonlinear device k (its injection
    scale 0, every other 1), on ``device`` (default: the CUDA card); with
    the selected device indices.  Needs >= 2 devices to be meaningful
    (with one, every harmonic loses its source)."""
    n_nl = net.n_nonlinear
    sel = list(range(n_nl)) if devices_out is None \
        else [int(d) for d in devices_out]
    bad = [d for d in sel if not 0 <= d < n_nl]
    if bad:
        raise ValueError(f"device indices {bad} out of range "
                         f"(0..{n_nl - 1})")
    rd, dv = settings.real_dtype, resolve_device(device)
    inj = torch.ones((len(sel), n_nl), dtype=rd, device=dv)
    inj[torch.arange(len(sel)), torch.tensor(sel, dtype=torch.long)] = 0.0
    one = torch.ones((len(sel),), dtype=rd, device=dv)
    return Scenarios(p_scale=one, q_scale=one.clone(),
                     injection_scale=inj), tuple(sel)


class ResonanceShiftReport(NamedTuple):
    """Impedance-scan view of an N-1 line screen
    (``hpfx.contingency.ResonanceShiftReport``): per-outage driving-point
    scans ``zmag`` (K, H, n) beside ``base_zmag`` (H, n), the largest
    amplification over orders > 1 and buses with where it lands, and the
    ranking by it."""
    outages: Tuple[int, ...]
    islanded: np.ndarray
    zmag: np.ndarray
    base_zmag: np.ndarray
    amplification: np.ndarray
    shift_order: np.ndarray
    shift_bus: np.ndarray
    ranking: np.ndarray


def _without_line(net: Network, k: int) -> Network:
    keep = torch.arange(net.line_from.shape[0], device=net.device) != int(k)
    return dataclasses.replace(
        net, **{f: getattr(net, f)[keep] for f in _LINE_FIELDS})


def outage_impedance_shift(net: Network, devices, settings: Settings, *,
                           outages: Optional[Sequence[int]] = None,
                           operational: bool = True
                           ) -> ResonanceShiftReport:
    """Resonance-shift screen: driving-point impedance scans under every
    N-1 line outage (``operational`` folds the Norton admittances in),
    ranked by how much an outage amplifies the impedance some harmonic
    injection sees."""
    from .impedance import driving_point_impedance
    sel, islanded, solvable = _line_selection(net, outages)
    dev = devices if operational else None
    base = _host(driving_point_impedance(net, settings, devices=dev))
    K, (H, n) = len(sel), base.shape
    zmag = np.full((K, H, n), np.nan)
    for k in solvable:
        zmag[sel.index(k)] = _host(driving_point_impedance(
            _without_line(net, k), settings, devices=dev))

    # slack column is grounded (|Z| = 0); guard the ratio there and at h=1
    safe = np.where(base > 0.0, base, np.inf)
    ratio = zmag / safe[None]
    ratio[:, 0, :] = -np.inf                     # fundamental excluded
    flat = np.where(np.isnan(ratio), -np.inf, ratio).reshape(K, -1)
    amp = flat.max(axis=1)
    pos = flat.argmax(axis=1)
    orders = np.asarray(settings.harmonics)
    amp = np.where(islanded, np.nan, amp)
    order_rank = np.argsort(np.where(islanded, -np.inf, amp))[::-1]
    return ResonanceShiftReport(
        outages=tuple(int(o) for o in sel), islanded=islanded,
        zmag=zmag, base_zmag=base, amplification=amp,
        shift_order=orders[pos // n].astype(np.int32),
        shift_bus=(pos % n).astype(np.int32), ranking=order_rank)


def screen_device_outages(net: Network, devices, settings: Settings, *,
                          devices_out: Optional[Sequence[int]] = None,
                          base=None, sweep=None) -> ContingencyReport:
    """N-1 converter-outage screen (:func:`device_outage_scenarios`
    through ``sweep``, default :func:`hpf_sweep`)."""
    base_thd = _base_case(net, devices, settings, base)
    scen, sel = device_outage_scenarios(net, settings,
                                        devices_out=devices_out,
                                        device=net.device)
    run = sweep if sweep is not None else hpf_sweep
    res = run(net, devices, settings, scen)
    thd = _host(get_thd(res.V_m.movedim(1, 0)).THD_F)
    return _assemble_report(
        sel, np.zeros(len(sel), bool), _host(res.converged),
        _host(res.n_iter).astype(np.int32), thd, base_thd,
        _host(res.V_m[:, 0, :].amin(dim=1)))


class ContingencySweepReport(NamedTuple):
    """(outage × scenario) screen outcome, K outages and S draws, numpy
    (``hpfx.contingency.ContingencySweepReport``): ``converged``,
    ``n_iter``, ``worst_thd`` (K, S); ``base_worst`` (S,) the intact
    network under the same draws; ``delta_q`` (K,) the ``quantile`` over
    draws of the worst-bus THD increase; ``conv_frac`` (K,); ``ranking``
    by descending ``delta_q``; ``infeasible`` (K, S) set only by
    ``verify_infeasible=True``."""
    outages: Tuple[int, ...]
    islanded: np.ndarray
    converged: np.ndarray
    n_iter: np.ndarray
    worst_thd: np.ndarray
    base_worst: np.ndarray
    delta_q: np.ndarray
    conv_frac: np.ndarray
    ranking: np.ndarray
    infeasible: np.ndarray


def solve_outage_pairs(net: Network, devices, settings: Settings,
                       lines: Sequence[int], scenarios: Scenarios):
    """Solve the (outaged line, draw) pairs ``lines[i]`` under
    ``scenarios``'s row i cold, in one batch-major batch: the zeroed-line
    networks of :func:`outage_ybus`, one per pair.  Returns the
    batch-major result."""
    outs = sorted(set(int(k) for k in lines))
    Y, lineY, lineY_f = outage_ybus(net, settings, outs)
    which = torch.tensor([outs.index(int(k)) for k in lines],
                         device=net.device)
    line = lambda l: None if l is None else l._replace(Ys=l.Ys[which],
                                                       d=l.d[which])
    return _hpf_sweep_vmap(net, devices, settings, scenarios,
                           Y=(Y[which], line(lineY), line(lineY_f)))


def _verify_infeasible_pairs(net: Network, devices, settings: Settings,
                             sel, p, q, inj, conv, islanded, worst,
                             n_iter):
    """Re-solve every unconverged non-islanded (outage, draw) pair cold in
    float64 on the caller's device, all in one batch.  Pairs that converge
    are merged back (the float32 knife-edge class); pairs that fail even
    in float64 are reported infeasible after this one cold start.
    Returns the updated (conv, worst, n_iter, infeasible)."""
    infeasible = np.zeros_like(conv)
    bad = np.argwhere(~conv & ~islanded[:, None])
    if bad.size == 0:
        return conv, worst, n_iter, infeasible
    f64 = torch.float64
    s_idx = torch.tensor(bad[:, 1], device=net.device)
    res = solve_outage_pairs(
        net.to(dtype=f64), devices.to(dtype=f64),
        settings.with_(dtype="float64"), [int(sel[k]) for k in bad[:, 0]],
        Scenarios(*(x[s_idx].to(f64) for x in (p, q, inj))))
    ok = _host(res.converged)
    w = _host(get_thd(res.V_m.movedim(1, 0)).THD_F.amax(dim=-1))
    its = _host(res.n_iter)
    for j, (k_idx, s_i) in enumerate(bad):
        if ok[j]:
            conv[k_idx, s_i] = True
            worst[k_idx, s_i] = float(w[j])
            n_iter[k_idx, s_i] += int(its[j])
        else:
            infeasible[k_idx, s_i] = True
    return conv, worst, n_iter, infeasible


def screen_line_outages_sweep(net: Network, devices, settings: Settings,
                              scenarios: Scenarios, *,
                              outages: Optional[Sequence[int]] = None,
                              quantile: float = 0.95,
                              verify_infeasible: bool = False
                              ) -> ContingencySweepReport:
    """N-1 line screen crossed with a scenario sweep: every (outage, draw)
    pair of the K solvable outages and S draws in one K·S batch on the
    device.  ``quantile``: ranking quantile over draws.
    ``verify_infeasible``: re-solve the unconverged pairs cold in float64
    (:func:`_verify_infeasible_pairs`); those that converge merge back,
    the rest are reported ``infeasible``.  ``device_mix`` scenarios are
    not supported."""
    if scenarios.device_mix is not None:
        raise ValueError("screen_line_outages_sweep does not support "
                         "device_mix scenarios")
    sel, islanded, solvable = _line_selection(net, outages)
    p = scenarios.p_scale
    q = scenarios.q_scale if scenarios.q_scale is not None else p
    inj = scenarios.injection_scale if scenarios.injection_scale \
        is not None else torch.ones_like(p)
    S = p.shape[0]

    # intact network under the same draws (the delta baseline)
    base = hpf_sweep(net, devices, settings, scenarios)
    base_worst = _host(get_thd(base.V_m.movedim(1, 0)).THD_F.amax(dim=-1))

    K = len(sel)
    conv = np.zeros((K, S), bool)
    n_iter = np.zeros((K, S), np.int32)
    worst = np.full((K, S), np.nan)
    if solvable:
        c, it, t, _ = _solve_networks(
            net, devices, settings, outage_ybus(net, settings, solvable),
            Scenarios(p, q, inj))
        pos = [sel.index(k) for k in solvable]
        conv[pos] = _host(c)
        n_iter[pos] = _host(it)
        worst[pos] = _host(t.amax(dim=-1))

    infeasible = np.zeros((K, S), bool)
    if verify_infeasible:
        conv, worst, n_iter, infeasible = _verify_infeasible_pairs(
            net, devices, settings, sel, p, q, inj, conv, islanded, worst,
            n_iter)

    with np.errstate(invalid="ignore"):
        delta = worst - base_worst[None, :]
        delta_q = np.nanquantile(
            np.where(conv, delta, np.nan), float(quantile), axis=1)
    conv_frac = conv.mean(axis=1)
    order = np.argsort(np.where(islanded | (conv_frac == 0),
                                -np.inf, delta_q))[::-1]
    return ContingencySweepReport(
        outages=tuple(int(o) for o in sel), islanded=islanded,
        converged=conv, n_iter=n_iter, worst_thd=worst,
        base_worst=base_worst, delta_q=delta_q, conv_frac=conv_frac,
        ranking=order, infeasible=infeasible)
