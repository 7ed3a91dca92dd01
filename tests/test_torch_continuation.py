"""The port's continuation sweeps and Kron reduction against the JAX
package, on the CPU: the host-driven warm-start continuation
(hpf_sweep_continuation, plain and adaptive stages, padding, explicit
keys, the merged rescue), the device-side continuation
(hpfx_torch.lanes.hpf_sweep_continuation_lanes, its ids named "device
continuation": "continuation_lanes" marks a test slow), kron_reduce,
expand/recover_voltages and hpf_sweep_kron.  Both packages start from the
same arrays (hpfx_torch.convert).

Tolerances: float64 on net2/net3 within V_TOL pu with identical
converged flags and iteration counts; float32 against the JAX float32
path within F32_TOL pu phasor, flags identical."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import kron as jkron
from hpfx import lanes as jl
from hpfx import solve as jsolve
from hpfx_torch import kron as tkron
from hpfx_torch import lanes as tl
from hpfx_torch.arrow import _make_arrow_consts
from hpfx_torch.harmonic import cleanup_voltages, lifted_threshold
from hpfx_torch.ybus import resolve_ybus

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_sweep_api import (DATA, LIBRARY, close, pair, phasor, same,
                                  scenarios, spread, to_np)

#: float32 port against float32 JAX, phasor pu (the two packages' float32
#: rounding through the same Newton path)
F32_TOL = 1e-4
#: reduced against unreduced solves in float64: both stop somewhere inside
#: the Newton test, on different arithmetic (tests/test_kron.py's bound)
KRON_TOL = 5e-8
ARROW = dict(solver="arrow", stable_mismatch=True)


def pair32(name, h_max, **kw):
    """Both packages' float32 settings, network and devices (the port's
    from the JAX package's arrays).  The JAX settings name float32: with
    x64 on, the JAX package's default dtype is float64."""
    s = hpfx.settings_for_hmax(h_max, coupled=True, dtype="float32", **kw)
    jnet = hpfx.load_network(os.path.join(DATA, f"{name}_buses.csv"),
                             os.path.join(DATA, f"{name}_lines.csv"), s)
    jdev = hpfx.load_device_set(jnet, s)
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    f32 = torch.float32
    return (s, jnet, jdev, ht.Settings(**dataclasses.asdict(s)),
            net.to(dtype=f32), dev.to(dtype=f32))


def scenarios32(*arrays):
    return (jsolve.Scenarios(*(jnp.asarray(a, jnp.float32) for a in arrays)),
            ht.Scenarios(*(torch.tensor(a, dtype=torch.float32)
                           for a in arrays)))


def hist_close(rt, rj, trips=3):
    """The same recorded trips (the NaN padding), the first ``trips``
    residuals within 1e-9 relative (1e-10 absolute, the float64 floor of
    a converged residual at net3): later ones follow the chaotic cold-start
    transient (residuals ~30), which multiplies the packages' float64
    rounding ~10x a trip, the plain hpf_sweep's histories as much."""
    a, b = to_np(rt.err_hist), to_np(rj.err_hist)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[:, :trips], b[:, :trips], rtol=1e-9,
                               atol=1e-10)


def same_flags(rj, rt):
    np.testing.assert_array_equal(to_np(rt.converged), to_np(rj.converged))
    np.testing.assert_array_equal(to_np(rt.n_iter), to_np(rj.n_iter))


# ---------------------------------------------------------------------------
# host-driven continuation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase_iters", [None, 3], ids=["plain", "adaptive"])
def test_host_continuation_matches(phase_iters):
    """Stages through hpf_sweep or hpf_sweep_adaptive(rescue=False), each
    seeded from its nearest converged neighbour: the same counts, flags and
    voltages as the JAX package, B=14 in 4 stages (two padding repeats)."""
    P = pair("net2", 5, **ARROW)
    p, q, inj, _ = spread(14, seed=5)
    sj, st = scenarios(p, q, inj)
    kw = dict(n_stages=4, phase_iters=phase_iters)
    rj = jsolve.hpf_sweep_continuation(P.jnet, P.jdev, P.s, sj, **kw)
    rt = ht.hpf_sweep_continuation(P.net, P.dev, P.ts, st, **kw)
    same(rj, rt)
    hist_close(rt, rj)
    assert rt.fund is None


def test_host_continuation_key_and_dense_phase2():
    """An explicit key (descending p) and a dense phase 2 at net3, where a
    PV bus moves the Jacobian's shape."""
    P = pair("net3", 5, **ARROW)
    p, q, inj, _ = spread(12, seed=7)
    sj, st = scenarios(p, q, inj)
    kw = dict(n_stages=3, key=-p, phase_iters=2,
              phase2_settings=P.ts.with_(solver="dense"))
    rj = jsolve.hpf_sweep_continuation(
        P.jnet, P.jdev, P.s, sj,
        **dict(kw, phase2_settings=P.s.with_(solver="dense")))
    rt = ht.hpf_sweep_continuation(P.net, P.dev, P.ts, st, **kw)
    same(rj, rt)


def test_host_continuation_rescue():
    """A budget of 4 trips leaves stages unconverged: the merged result's
    self-warm and cold rescue passes take them, as in the JAX package
    (with and without the rescue)."""
    P = pair("net2", 5, **ARROW)
    s, ts = P.s.with_(max_iter_h=4), P.ts.with_(max_iter_h=4)
    p, q, inj, _ = spread(12, seed=11)
    inj = inj * 1.6
    sj, st = scenarios(p, q, inj)
    for rescue in (False, True):
        rj = jsolve.hpf_sweep_continuation(P.jnet, P.jdev, s, sj,
                                           n_stages=3, rescue=rescue)
        rt = ht.hpf_sweep_continuation(P.net, P.dev, ts, st, n_stages=3,
                                       rescue=rescue)
        same_flags(rj, rt)
        ok = to_np(rj.converged)
        if not rescue:
            assert not ok.all()
        close(to_np(rt.V_m)[ok], to_np(rj.V_m)[ok])
        close(phasor(rt)[ok], phasor(rj)[ok])


def test_host_continuation_device_mix_key():
    """With no injection scale and a device mix, the key is the summed mix
    (a DeviceLibrary sweep)."""
    P = pair("net2", 5, **ARROW)
    jlib = hpfx.load_device_library(LIBRARY, P.s)
    lib = ht.library_from_hpfx_arrays(dict(
        I_lib=(np.asarray(jlib.I_lib.re), np.asarray(jlib.I_lib.im)),
        Y_lib=(np.asarray(jlib.Y_lib.re), np.asarray(jlib.Y_lib.im)),
        coupled=jlib.coupled, names=jlib.names), device="cpu")
    p, q, _, mix = spread(8, n_nl=1, seed=2, mix_types=len(LIBRARY))
    sj, st = scenarios(p, q, None, mix)
    rj = jsolve.hpf_sweep_continuation(P.jnet, jlib, P.s, sj, n_stages=2)
    rt = ht.hpf_sweep_continuation(P.net, lib, P.ts, st, n_stages=2)
    same(rj, rt)


# ---------------------------------------------------------------------------
# device-side continuation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["net2", "net3"])
def test_device_continuation_matches(name):
    """The device-side schedule: stable argsort, padded chunks, the nearest
    converged seed of the previous chunk, the unchunk by ``order``; B=14
    in 4 stages."""
    P = pair(name, 5, **ARROW)
    p, q, inj, _ = spread(14, seed=5)
    sj, st = scenarios(p, q, inj)
    rj = jl.hpf_sweep_continuation_lanes(P.jnet, P.jdev, P.s, sj, n_stages=4)
    rt = tl.hpf_sweep_continuation_lanes(P.net, P.dev, P.ts, st, n_stages=4)
    same(rj, rt)
    hist_close(rt, rj)


def test_device_continuation_ties_sort_stably():
    """Tied keys (every injection scale equal) keep their input order in
    the chunks and in the gathered rescue; a budget of 3 trips makes the
    rescue passes run."""
    P = pair("net2", 5, **ARROW)
    s, ts = P.s.with_(max_iter_h=3), P.ts.with_(max_iter_h=3)
    p, q, _, _ = spread(10, seed=13)
    inj = np.full(10, 1.3)
    sj, st = scenarios(p * 1.2, q, inj)
    for rescue in (False, True):
        rj = jl.hpf_sweep_continuation_lanes(P.jnet, P.jdev, s, sj,
                                             n_stages=3, rescue=rescue)
        rt = tl.hpf_sweep_continuation_lanes(P.net, P.dev, ts, st,
                                             n_stages=3, rescue=rescue)
        same_flags(rj, rt)
        close(rt.V_m, rj.V_m)
        hist_close(rt, rj)


def test_device_continuation_per_device_scales_and_mix():
    """Per-device injection scales (the key their mean) and a device mix
    (batched lane devices gathered per chunk)."""
    P = pair("net2", 5, **ARROW)
    p, q, inj, _ = spread(8, n_nl=1, seed=3)
    sj, st = scenarios(p, q, inj)
    same(jl.hpf_sweep_continuation_lanes(P.jnet, P.jdev, P.s, sj, n_stages=2),
         tl.hpf_sweep_continuation_lanes(P.net, P.dev, P.ts, st, n_stages=2))
    jlib = hpfx.load_device_library(LIBRARY, P.s)
    lib = ht.library_from_hpfx_arrays(dict(
        I_lib=(np.asarray(jlib.I_lib.re), np.asarray(jlib.I_lib.im)),
        Y_lib=(np.asarray(jlib.Y_lib.re), np.asarray(jlib.Y_lib.im)),
        coupled=jlib.coupled, names=jlib.names), device="cpu")
    _, _, _, mix = spread(8, n_nl=1, seed=4, mix_types=len(LIBRARY))
    sj, st = scenarios(p, q, None, mix)
    same(jl.hpf_sweep_continuation_lanes(P.jnet, jlib, P.s, sj, n_stages=2),
         tl.hpf_sweep_continuation_lanes(P.net, lib, P.ts, st, n_stages=2))


def test_device_continuation_f32():
    """float32 against the JAX float32 path at net2 H<=25 (the bench's
    stage, cut to B=16): flags identical, phasors within F32_TOL."""
    s, jnet, jdev, ts, net, dev = pair32("net2", 25, **ARROW,
                                         big_solve="panel")
    B = 16
    p = np.linspace(0.8, 1.2, B)
    sj, st = scenarios32(p, p, np.linspace(0.6, 1.4, B))
    rj = jl.hpf_sweep_continuation_lanes(jnet, jdev, s, sj, n_stages=4)
    rt = tl.hpf_sweep_continuation_lanes(net, dev, ts, st, n_stages=4)
    np.testing.assert_array_equal(to_np(rt.converged), to_np(rj.converged))
    assert to_np(rt.converged).all()
    close(phasor(rt), phasor(rj), F32_TOL)


def _former(net, devices, settings, scenarios, n_stages):
    """The former ``hpf_sweep_continuation_lanes`` on one device, for a
    DeviceSet and per-scenario scales, without a log, kept as the
    reference for its rescue: there a gathered lane already converged kept
    a threshold lifted to its own error, so where the floor had lifted its
    threshold it took a trip from its own state, and from the cold start
    it ran until it met that error again, for results the pass then
    dropped.  Returns the result, the gathered lanes converged with a
    lifted threshold and, for each rescue pass, the trips its loop ran and
    the most trips a lane whose result it kept took there."""
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    rd, dv = settings.real_dtype, net.device
    B = scenarios.p_scale.shape[0]
    Y, lineY, lineY_f = resolve_ybus(net, settings)
    key = scenarios.injection_scale.to(rd)
    inj_db = tl._as_inj_db(key, n - m, B)
    dev = tl._as_lane_devices(devices)
    S = tl.Cx(tl._scale_cols(net.bus_P, scenarios.p_scale),
              tl._scale_cols(net.bus_Q, scenarios.q_scale))
    order = torch.argsort(key, stable=True)
    Bc = -(-B // n_stages)
    order_p = torch.cat([order, order[-1:].expand(n_stages * Bc - B)])

    def gather(sel):
        g = lambda x: x.index_select(-1, sel)
        return tl.Cx(g(S.re), g(S.im)), g(inj_db), dev

    def cold_state(S_k, Bk):
        fund = tl.solve_fundamental_lanes(Y[0], S_k, net, settings, Bk,
                                          lineY_f)
        Vm = torch.full((H, n, Bk), settings.v_init_h, dtype=rd, device=dv)
        Va = torch.full((H, n, Bk), settings.a_init_h, dtype=rd, device=dv)
        Vm[0], Va[0] = fund.V_m, fund.V_a
        return Vm, Va

    consts = _make_arrow_consts(H, n, m, c, rd, dv)
    pVm = torch.zeros((H, n, Bc), dtype=rd, device=dv)
    pVa = torch.zeros_like(pVm)
    pK = torch.zeros((Bc,), dtype=rd, device=dv)
    pConv = torch.zeros((Bc,), dtype=rd, device=dv)
    outs = []
    for st in range(n_stages):
        sel = order_p[st * Bc:(st + 1) * Bc]
        S_c, inj_c, dev_c = gather(sel)
        kc = key.index_select(0, sel)
        coldVm, coldVa = cold_state(S_c, Bc)
        dist = (kc[:, None] - pK[None, :]).abs() \
            + 1e30 * (1.0 - pConv)[None, :]
        j = torch.argmin(dist, dim=1)
        haveprev = (pConv > 0).any()
        Vm0 = torch.where(haveprev, pVm[:, :, j], coldVm)
        Va0 = torch.where(haveprev, pVa[:, :, j], coldVa)
        thresh = tl._thresh_lanes(coldVm, Y, dev_c, inj_c, m, settings)
        Vm, Va, err, n_it, hist = tl.nr_trip_lanes(
            Y, lineY, S_c, dev_c, inj_c, Vm0, Va0, settings, consts, thresh)
        conv = err <= thresh
        pVm, pVa, pK, pConv = Vm, Va, kc, conv.to(rd)
        outs.append((Vm, Va, err, n_it, hist, conv))

    def unchunk(xs):
        flat = torch.cat(xs, dim=-1)[..., :B]
        out = torch.zeros_like(flat)
        out[..., order] = flat
        return out

    V_m, V_a, err, n_iter, hist, conv = map(unchunk, zip(*outs))

    # the former _continuation_rescue
    bad = torch.argsort(conv.to(rd), stable=True)[:min(Bc, B)]
    was_bad = ~conv[bad]
    g = lambda x: x.index_select(-1, bad)
    S_k, inj_k, dev_k = gather(bad)
    coldVm, coldVa = cold_state(S_k, bad.shape[0])
    thresh_k = tl._thresh_lanes(coldVm, Y, dev_k, inj_k, m, settings)
    lifted = int((lifted_threshold(thresh_k, settings) & conv[bad]).sum())
    passes = []

    def rescue_pass(Vmk, Vak, errk, nitk, histk, convk, Vm0, Va0):
        thresh_r = torch.where(convk, torch.maximum(thresh_k, errk),
                               thresh_k)
        Vm2, Va2, err2, nit2, hist2 = tl.nr_trip_lanes(
            Y, lineY, S_k, dev_k, inj_k, Vm0, Va0, settings, consts,
            thresh_r)
        redo = ~convk
        passes.append((int(nit2.max()), int(torch.where(redo, nit2, 0).max())))
        return (torch.where(redo[None, None, :], Vm2, Vmk),
                torch.where(redo[None, None, :], Va2, Vak),
                torch.where(redo, err2, errk),
                nitk + torch.where(redo, nit2, 0),
                torch.where(redo[None, :], hist2, histk),
                convk | (redo & (err2 <= thresh_r)))

    Vmk, Vak = g(V_m), g(V_a)
    finite = (torch.isfinite(Vmk).flatten(0, 1).all(dim=0)
              & torch.isfinite(Vak).flatten(0, 1).all(dim=0))
    use_self = (finite | conv[bad])[None, None, :]
    state = (Vmk, Vak, err[bad], n_iter[bad], g(hist), conv[bad])
    state = rescue_pass(*state, torch.where(use_self, Vmk, coldVm),
                        torch.where(use_self, Vak, coldVa))
    state = rescue_pass(*state, coldVm, coldVa)

    def sc(full, kk, mask):
        out = full.clone()
        out[..., bad] = torch.where(mask, kk, g(full))
        return out

    lane = was_bad[None, None, :]
    V_m, V_a = cleanup_voltages(sc(V_m, state[0], lane),
                                sc(V_a, state[1], lane))
    res = ht.HPFResult(V_m=torch.movedim(V_m, -1, 0),
                       V_a=torch.movedim(V_a, -1, 0),
                       err=sc(err, state[2], was_bad),
                       n_iter=sc(n_iter, state[3], was_bad),
                       err_hist=sc(hist, state[4], was_bad[None, :]).T,
                       converged=sc(conv, state[5], was_bad), fund=None)
    return res, lifted, passes


@pytest.mark.parametrize("dtype,thresh_h", [("float32", 1e-6),
                                            ("float64", 1e-14)],
                         ids=["float32", "float64"])
def test_device_continuation_rescue_is_the_former(dtype, thresh_h):
    """The device continuation's rescue, the adaptive sweep's gathered pass
    since it shares it, against its former copy: every output bit for
    bit, and the rescue's harmonic trips those of the lanes whose results
    it keeps.  net2 H<=25 at B=16 in 4 stages, 10 trips of budget: the
    stages leave stragglers and the warm pass converges every one of them,
    so the cold pass keeps nothing; ``thresh_h`` lies below the
    floor-aware threshold of some gathered lanes that had converged."""
    s = ht.settings_for_hmax(25, coupled=True, dtype=dtype).with_(
        solver="arrow", stable_mismatch=True, max_iter_h=10,
        thresh_h=thresh_h)
    net = ht.load_network(f"{DATA}/net2_buses.csv", f"{DATA}/net2_lines.csv",
                          s, device="cpu")
    dev = ht.load_device_set(net, s)
    gen = torch.Generator().manual_seed(13)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(16, generator=gen,
                                                    dtype=torch.float64)
                        ).to(s.real_dtype)
    sc = ht.Scenarios(u(0.85, 1.15), u(0.85, 1.15), u(0.6, 1.4))
    log = ht.PhaseLog()
    res = tl.hpf_sweep_continuation_lanes(net, dev, s, sc, n_stages=4,
                                          log=log)
    ref, lifted, ((_, warm), (cold_loop, cold)) = _former(net, dev, s, sc, 4)
    assert res.V_m.dtype == s.real_dtype
    for k in ("V_m", "V_a", "err", "n_iter", "converged"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k
    h, hr = res.err_hist, ref.err_hist
    assert torch.equal(torch.isnan(h), torch.isnan(hr))
    assert torch.equal(torch.nan_to_num(h), torch.nan_to_num(hr))

    assert bool(res.converged.all()) and lifted > 0 and warm > 0
    # the former cold pass ran the converged lanes again and kept nothing;
    # each pass now runs as long as the lanes it keeps
    assert cold == 0 < cold_loop
    assert log.harmonic_trips["rescue"] == warm + cold


# ---------------------------------------------------------------------------
# Kron reduction
# ---------------------------------------------------------------------------

def test_kron_reduce_matches():
    """net2's passive bus 3: the same eliminated set, reduced network,
    reduced admittances and recovery operator."""
    P = pair("net2", 25)
    np.testing.assert_array_equal(tkron.passive_buses(P.net),
                                  jkron.passive_buses(P.jnet))
    rj = jkron.kron_reduce(P.jnet, P.s)
    rt = ht.kron_reduce(P.net, P.ts)
    np.testing.assert_array_equal(rt.keep, rj.keep)
    np.testing.assert_array_equal(rt.elim, rj.elim)
    for k in ("Y", "R"):
        close(getattr(rt, k).re, getattr(rj, k).re, 1e-12)
        close(getattr(rt, k).im, getattr(rj, k).im, 1e-12)
    for f in dataclasses.fields(rj.net):
        a, b = getattr(rt.net, f.name), getattr(rj.net, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert a == b, f.name
    assert tkron.passive_buses(pair("net1", 5).net).size == \
        jkron.passive_buses(pair("net1", 5).jnet).size


def test_recover_voltages_single_case():
    """The reduced single-case solve expanded to the full network: the
    same voltages as the JAX package's recovery and as the unreduced
    solve."""
    P = pair("net2", 25)
    rj = jkron.kron_reduce(P.jnet, P.s)
    rt = ht.kron_reduce(P.net, P.ts)
    hj = hpfx.hpf(rj.net, P.jdev, P.s, Y=rj.Y)
    ht_ = ht.hpf(rt.net, P.dev, P.ts, Y=rt.Y)
    assert int(ht_.n_iter) == int(hj.n_iter)
    Vj = jkron.recover_voltages(rj, hj, P.jnet.n)
    Vt = ht.recover_voltages(rt, ht_, P.net.n)
    close(Vt[0], Vj[0], 1e-8)
    full = ht.hpf(P.net, P.dev, P.ts)
    close(Vt[0], full.V_m, KRON_TOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sweep_kron_matches(dtype):
    """hpf_sweep_kron on the arrow lanes path with a dense reduced Y and no
    lines: the JAX package's result (float64: V_TOL and identical counts;
    float32: F32_TOL, flags identical), full size, and in float64 the
    unreduced sweep's magnitudes within KRON_TOL."""
    P = pair("net2", 5, **ARROW)
    p, q, inj, _ = spread(8, seed=9)
    if dtype == "float64":
        sj, st = scenarios(p, q, inj)
        s, ts, jnet, jdev, net, dev = P.s, P.ts, P.jnet, P.jdev, P.net, P.dev
    else:
        s, jnet, jdev, ts, net, dev = pair32("net2", 5, **ARROW)
        sj, st = scenarios32(p, q, inj)
    rj = jsolve.hpf_sweep_kron(jnet, jdev, s, sj)
    rt = ht.solve.hpf_sweep_kron(net, dev, ts, st)
    assert tuple(rt.V_m.shape) == (8, s.n_harmonics, 4)
    if dtype == "float64":
        same(rj, rt)
        full = ht.hpf_sweep(net, dev, ts, st)
        close(rt.V_m, full.V_m, KRON_TOL)
    else:
        np.testing.assert_array_equal(to_np(rt.converged),
                                      to_np(rj.converged))
        close(phasor(rt), phasor(rj), F32_TOL)
