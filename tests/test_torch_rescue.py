"""The device sweep's gathered rescue (hpfx_torch.lanes.
hpf_sweep_adaptive_lanes) against a copy of its former passes, kept here
as the reference: there a gathered lane that was already converged kept a
threshold lifted to its own error, so from the cold start it stayed active
and the restart ran its whole budget, and both passes ran whatever phase 1
left.  Only the results of the lanes a pass is given unconverged are kept,
so the program's passes now run those lanes alone and are skipped where
there are none: every output must equal the copy's bit for bit, in float32
and float64, on net2 H<=25 at B=32.

Cases: "none", phase 1 converges every lane; "phase2", phase 1 capped at 2
trips from the linear seed, so that the gathered batch holds stragglers
and converged padding, phase 2 converges the stragglers and the copy's
restart runs 50 trips for nothing; "restart", a seed V0 whose odd lanes
are NaN and a phase-1 cap of 40, so that phase 2 (cold, 10 trips of
budget) leaves the slower of them to the cold restart beside padding."""
import math
import os

import pytest
import torch

import hpfx_torch as ht
from hpfx_torch import lanes as tl
from hpfx_torch.harmonic import cleanup_voltages

from test_torch_foundations import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
B = 32

#: case -> (warm, phase_iters, NaN seed on odd lanes)
CASES = {"none": ("linear", 24, False),
         "phase2": ("linear", 2, False),
         "restart": ("cold", 40, True)}


def _former(net, devices, settings, scenarios, phase_iters, warm, V0):
    """The former ``hpf_sweep_adaptive_lanes`` on one device at the
    default width, without ``I_bg``.  Returns the result, the gathered
    lanes unconverged after phase 1 and, for each pass, the most trips a
    lane whose result it kept took there."""
    dv = net.device
    su = tl._sweep_setup(net, devices, settings, scenarios)
    rd = settings.real_dtype
    Bs = scenarios.p_scale.shape[0]
    p1 = min(phase_iters, settings.max_iter_h)
    if V0 is not None:
        Vm1 = torch.movedim(V0[0].to(rd), 0, -1).clone()
        Va1 = torch.movedim(V0[1].to(rd), 0, -1).clone()
        Vm1[0], Va1[0] = su.fund.V_m, su.fund.V_a
    elif warm == "linear":
        Vm1, Va1 = tl._linear_seed_lanes(su, net, settings)
    else:
        Vm1, Va1 = su.cold_V_m, su.cold_V_a
    V_m, V_a, err, n_iter, hist1 = tl.nr_trip_lanes(
        su.Y, su.lineY, su.S, su.dev, su.inj_db, Vm1, Va1,
        settings.with_(max_iter_h=p1), su.consts, su.thresh)
    conv = err <= su.thresh
    hist = torch.full((settings.max_iter_h, Bs), float("nan"), dtype=rd,
                      device=dv)
    hist[:p1] = hist1
    K = min(Bs, max(128, Bs // 16))
    bad = torch.argsort(conv.to(rd), stable=True)[:K]
    was_bad = ~conv[bad]
    g = lambda x: x.index_select(-1, bad)
    gcx = lambda z: None if z is None else tl.Cx(g(z.re), g(z.im))
    S_k, inj_k, dev_k = gcx(su.S), g(su.inj_db), su.dev
    if isinstance(dev_k, tl.LaneDevices) and dev_k.batched:
        dev_k = dev_k._replace(I_N=gcx(dev_k.I_N), Y_N=gcx(dev_k.Y_N))
    thresh_k = g(su.thresh)
    coldVm_k, coldVa_k = g(su.cold_V_m), g(su.cold_V_a)
    kept_trips = {}

    def rescue_pass(name, s_pass, Vm0, Va0, state):
        Vmk, Vak, errk, nitk, convk = state
        thresh_r = torch.where(convk, torch.maximum(thresh_k, errk),
                               thresh_k)
        Vm2, Va2, err2, nit2, hist2 = tl.nr_trip_lanes(
            su.Y, su.lineY, S_k, dev_k, inj_k, Vm0, Va0, s_pass,
            su.consts, thresh_r)
        redo = ~convk
        kept_trips[name] = int(torch.where(redo, nit2, 0).max())
        Vmk = torch.where(redo[None, None, :], Vm2, Vmk)
        Vak = torch.where(redo[None, None, :], Va2, Vak)
        errk = torch.where(redo, err2, errk)
        nitk = nitk + torch.where(redo, nit2, 0)
        convk = convk | (redo & (err2 <= thresh_r))
        return (Vmk, Vak, errk, nitk, convk), redo, hist2

    state = (g(V_m), g(V_a), g(err), g(n_iter), conv[bad])
    if p1 < settings.max_iter_h:
        Vmk, Vak = state[0], state[1]
        finite = (torch.isfinite(Vmk).flatten(0, 1).all(dim=0)
                  & torch.isfinite(Vak).flatten(0, 1).all(dim=0))
        use_self = (finite | state[4])[None, None, :]
        Vmc, Vac = cleanup_voltages(Vmk, Vak)
        s2 = settings.with_(max_iter_h=settings.max_iter_h - p1)
        state, redo, hist2 = rescue_pass(
            "rescue_phase2", s2, torch.where(use_self, Vmc, coldVm_k),
            torch.where(use_self, Vac, coldVa_k), state)
        hist[p1:, bad] = torch.where(redo[None, :], hist2, hist[p1:, bad])
    state, redo, hist3 = rescue_pass("cold_restart", settings, coldVm_k,
                                     coldVa_k, state)
    hist[:, bad] = torch.where(redo[None, :], hist3, hist[:, bad])
    Vmk, Vak, errk, nitk, convk = state

    def sc(full, kk, mask):
        out = full.clone()
        out[..., bad] = torch.where(mask, kk, g(full))
        return out

    V_m = sc(V_m, Vmk, was_bad[None, None, :])
    V_a = sc(V_a, Vak, was_bad[None, None, :])
    err = sc(err, errk, was_bad)
    n_iter = sc(n_iter, nitk, was_bad)
    conv = sc(conv, convk, was_bad)
    V_m, V_a = cleanup_voltages(V_m, V_a)
    res = tl._lanes_result(V_m, V_a, err, n_iter, hist, su.thresh, su.fund)
    return res._replace(converged=conv), int(was_bad.sum()), kept_trips


@pytest.fixture(scope="module",
                params=[(c, d) for c in CASES
                        for d in ("float32", "float64")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    """The program's sweep with a log, and the former passes', on one
    seeded batch."""
    case, dtype = request.param
    warm, phase_iters, nan_seed = CASES[case]
    s = ht.settings_for_hmax(25, coupled=True, dtype=dtype).with_(
        solver="arrow", stable_mismatch=True, big_solve="panel")
    net = ht.load_network(f"{DATA}/net2_buses.csv", f"{DATA}/net2_lines.csv",
                          s, device="cpu")
    dev = ht.load_device_set(net, s)
    gen = torch.Generator().manual_seed(3)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(B, generator=gen,
                                                    dtype=torch.float64)
                        ).to(s.real_dtype)
    sc = ht.Scenarios(u(0.6, 1.4), u(0.6, 1.4), u(0.4, 1.6))
    V0 = None
    if nan_seed:
        H, n = s.n_harmonics, net.n
        V0 = (torch.full((B, H, n), s.v_init_h, dtype=s.real_dtype),
              torch.full((B, H, n), s.a_init_h, dtype=s.real_dtype))
        V0[0][1::2] = float("nan")
    log = ht.PhaseLog()
    res = ht.hpf_sweep_adaptive_lanes(net, dev, s, sc,
                                      phase_iters=phase_iters, warm=warm,
                                      V0=V0, log=log)
    former = _former(net, dev, s, sc, phase_iters, warm, V0)
    return case, s, res, log, former


def test_rescue_is_the_former_bit_for_bit(runs):
    _, s, res, _, (ref, _, _) = runs
    assert res.V_m.dtype == s.real_dtype
    for k in ("V_m", "V_a", "err", "n_iter", "converged"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k
    h, hr = res.err_hist, ref.err_hist
    assert torch.equal(torch.isnan(h), torch.isnan(hr))
    assert torch.equal(torch.nan_to_num(h), torch.nan_to_num(hr))


def test_rescue_counts_its_stragglers_and_kept_trips(runs):
    case, s, res, log, (_, stragglers, kept_trips) = runs
    assert {"rescue_phase2", "cold_restart"} <= set(log.seconds)
    assert log.stragglers == stragglers
    if case == "none":
        assert stragglers == 0
        assert log.trips["rescue_phase2"] == log.trips["cold_restart"] == 0
        return
    assert 0 < stragglers < B
    # each pass runs as long as the lanes it keeps: the former restart ran
    # its whole budget for the padding alone
    assert log.trips["rescue_phase2"] == kept_trips["rescue_phase2"] > 0
    assert log.trips["cold_restart"] == kept_trips["cold_restart"]
    if case == "restart":
        assert 0 < kept_trips["cold_restart"] < s.max_iter_h
    else:
        assert kept_trips["cold_restart"] == 0
    assert bool(res.converged.all())
    assert math.isfinite(float(res.err.max()))
