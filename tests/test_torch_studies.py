"""The port's study layer against the JAX package, on the CPU in
float64: flows (line flows, IEEE 519, EN 50160, IEEE 1459, K-factor),
iec (summation law, apportioning), capacity (Monte-Carlo draws, the
compliance fraction and the bisection), studies (quantile assessment,
time series, percentile compliance, planning levels), checkpoint (an
archive of either package loads in the other) and trajlog (the same
bytes from the same trajectory).

The reductions are held on the same inputs: the JAX package's solved
voltages, or seeded (B, H, n) magnitude tensors with some scenarios
marked unconverged, go through both packages.  The solves (capacity and
the studies) run net2 H<=5, B <= 8, held to V_TOL with identical counts
and flags."""
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import capacity as jcap
from hpfx import flows as jf
from hpfx import iec as ji
from hpfx import studies as jst
from hpfx import trajlog as jtl
from hpfx_torch import trajlog as ttl
from hpfx_torch.cx import Cx

from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_sweep_api import V_TOL, pair, same, to_np

#: reductions of the same inputs: relative to their scale
R_TOL = 1e-13


def _close(got, want, rtol=R_TOL):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
        return
    scale = max(1.0, np.nanmax(np.abs(np.where(np.isfinite(want), want,
                                                0.0))))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


class _Result(NamedTuple):
    """A batched result's fields the reductions read."""
    V_m: object
    V_a: object
    converged: object


def _batch(H, n, B=64, seed=2):
    """Seeded batched magnitudes and angles, every fourth scenario
    unconverged, as a JAX and a port result."""
    rng = np.random.default_rng(seed)
    Vm = rng.uniform(0.001, 0.12, (B, H, n))
    Vm[:, 0] = rng.uniform(0.9, 1.05, (B, n))
    Va = rng.uniform(0.0, 2 * np.pi, (B, H, n))
    conv = np.arange(B) % 4 != 3
    return (_Result(jnp.asarray(Vm), jnp.asarray(Va), jnp.asarray(conv)),
            _Result(torch.tensor(Vm), torch.tensor(Va), torch.tensor(conv)))


@pytest.fixture(scope="module")
def solved():
    """net2 H<=7 in float64: the JAX package's single-case solution, with
    its trajectory."""
    P = pair("net2", 7)
    return P, hpfx.hpf(P.jnet, P.jdev, P.s, record_trajectory=True)


def test_line_flows_and_indices_match_jax(solved):
    """line_flows, line_power_indices (both ends), power_indices and
    k_factor on the same solved voltages."""
    P, r = solved
    Vm, Va = np.asarray(r.V_m), np.asarray(r.V_a)
    a = jf.line_flows(P.jnet, P.s, Vm, Va)
    b = ht.line_flows(P.net, P.ts, torch.tensor(Vm), torch.tensor(Va))
    for f in ("I_f", "I_t"):
        _close(getattr(b, f).re, getattr(a, f).re)
        _close(getattr(b, f).im, getattr(a, f).im)
    for f in ("P_f", "Q_f", "P_t", "Q_t", "loss", "total_loss"):
        _close(getattr(b, f), getattr(a, f))
    for side in ("from", "to"):
        ja = jf.line_power_indices(P.jnet, P.s, Vm, Va, side=side)
        tb = ht.line_power_indices(P.net, P.ts, torch.tensor(Vm),
                                   torch.tensor(Va), side=side)
        for x, y in zip(tb, ja):
            _close(x, y)
    with pytest.raises(ValueError):
        ht.line_power_indices(P.net, P.ts, torch.tensor(Vm),
                              torch.tensor(Va), side="middle")
    _close(ht.k_factor(b.I_f.abs(), P.s.harmonics),
           jf.k_factor(a.I_f.abs(), P.s.harmonics))


@pytest.mark.parametrize("isc", [15.0, 500.0, 5000.0])
def test_voltage_and_current_limits_match_jax(solved, isc):
    """check_ieee519 (two voltage classes), check_en50160 and
    check_ieee519_current (three short-circuit ratios) on the same
    solved voltages and currents."""
    P, r = solved

    class R(NamedTuple):
        V_m: object

    a = jf.check_ieee519(r, P.s)
    b = ht.check_ieee519(R(torch.tensor(np.asarray(r.V_m))), P.ts)
    c = ht.check_ieee519(R(torch.tensor(np.asarray(r.V_m))), P.ts, v_kv=100)
    assert c.limit_thd == jf.check_ieee519(r, P.s, v_kv=100).limit_thd
    for f in ("ratio", "worst_ratio", "worst_order", "thd", "compliant"):
        _close(getattr(b, f), getattr(a, f))
    assert (b.harmonics, b.limit_individual, b.limit_thd) == \
        (a.harmonics, a.limit_individual, a.limit_thd)
    a = jf.check_en50160(r, P.s)
    b = ht.check_en50160(R(torch.tensor(np.asarray(r.V_m))), P.ts)
    for f in ("ratio", "limits", "margin", "worst_order", "thd",
              "compliant"):
        _close(getattr(b, f), getattr(a, f))
    fl = jf.line_flows(P.jnet, P.s, r.V_m, r.V_a)
    I_m = np.asarray(fl.I_f.abs())[:, 0]
    a = jf.check_ieee519_current(jnp.asarray(I_m), P.s.harmonics, isc)
    b = ht.check_ieee519_current(torch.tensor(I_m), P.s.harmonics, isc)
    for f in ("ratio", "limits", "tdd", "compliant"):
        _close(getattr(b, f), getattr(a, f))
    assert b.limit_tdd == a.limit_tdd and b.harmonics == a.harmonics


def test_batched_screens_match_jax():
    """ieee519_screen and en50160_screen on a seeded batch with
    unconverged scenarios; en50160_limit_vector goes to the card unless
    a device is named."""
    H, n = 13, 4
    jr, tr = _batch(H, n)
    s = hpfx.settings_for_hmax(25)
    ts = ht.settings_for_hmax(25, dtype="float64")
    for jfun, tfun in ((jf.ieee519_screen, ht.ieee519_screen),
                       (jf.en50160_screen, ht.en50160_screen)):
        a, b = jfun(jr, s), tfun(tr, ts)
        for x, y in zip(b, a):
            _close(x, y)
    _close(ht.flows.en50160_limit_vector(s.harmonics, device="cpu"),
           jf.en50160_limit_vector(s.harmonics))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ht.flows.en50160_limit_vector(s.harmonics)


def test_iec_aggregation_matches_jax():
    """summation_alpha, summation_law (per-order and explicit exponents),
    aggregate_contributions and apportion_planning_level."""
    rng = np.random.default_rng(9)
    hs = (1, 3, 5, 7, 11, 13)
    np.testing.assert_array_equal(ht.summation_alpha(hs),
                                  ji.summation_alpha(hs))
    mags = rng.uniform(0.0, 0.05, (4, len(hs), 3))
    _close(ht.summation_law(torch.tensor(mags), harmonics=hs, axis=0,
                            h_axis=1),
           ji.summation_law(jnp.asarray(mags), harmonics=hs, axis=0,
                            h_axis=1))
    _close(ht.summation_law(torch.tensor(mags), alpha=1.4, axis=2),
           ji.summation_law(jnp.asarray(mags), alpha=1.4, axis=2))
    with pytest.raises(ValueError):
        ht.summation_law(torch.tensor(mags), harmonics=hs, axis=1,
                         h_axis=1)
    shape = (len(hs), 5, 3)
    c = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    jc = hpfx.Cx(jnp.asarray(c.real), jnp.asarray(c.imag))
    tc = Cx(torch.tensor(c.real), torch.tensor(c.imag))
    _close(ht.aggregate_contributions(tc, hs),
           ji.aggregate_contributions(jc, hs))
    _close(ht.aggregate_contributions(tc, hs, alpha=2.0),
           ji.aggregate_contributions(jc, hs, alpha=2.0))
    S = [10.0, 30.0, 60.0]
    L = np.linspace(1.0, 3.0, len(hs))
    _close(ht.apportion_planning_level(torch.tensor(L), S, harmonics=hs),
           ji.apportion_planning_level(jnp.asarray(L), S, harmonics=hs))
    _close(ht.apportion_planning_level(2.0, S, S_total=120.0, alpha=1.4),
           ji.apportion_planning_level(2.0, S, S_total=120.0, alpha=1.4))


@pytest.mark.parametrize("per_device", [True, False],
                         ids=["per_device", "scalar"])
def test_monte_carlo_draws_match_jax(per_device):
    """monte_carlo_scenarios draws numpy's numbers in the JAX package's
    order, exactly, in float64 and float32; scale_scenarios with and
    without a device mask."""
    P = pair("net1", 5)
    for dt in ("float32", "float64"):
        s, ts = P.s.with_(dtype=dt), P.ts.with_(dtype=dt)
        a = jcap.monte_carlo_scenarios(7, 16, P.jnet, s, inj_spread=0.3,
                                       per_device=per_device)
        b = ht.monte_carlo_scenarios(7, 16, P.net, ts, inj_spread=0.3,
                                     per_device=per_device, device="cpu")
        for x, y in zip(b, a):
            if y is not None:
                np.testing.assert_array_equal(to_np(x), np.asarray(y))
    mask = np.zeros(P.net.n_nonlinear)
    mask[2] = 1.0
    for m in (None, mask):
        a2 = jcap.scale_scenarios(a, 1.7, m)
        b2 = ht.scale_scenarios(b, 1.7, m)
        np.testing.assert_array_equal(to_np(b2.injection_scale),
                                      np.asarray(a2.injection_scale))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ht.monte_carlo_scenarios(7, 4, P.net, P.ts)


def test_hosting_capacity_matches_jax():
    """compliance_fraction (both criteria) and find_hosting_capacity on
    net2 H<=5, B=8, through hpf_sweep: the same probed levels and
    fractions."""
    P = pair("net2", 5)
    a = jcap.monte_carlo_scenarios(3, 8, P.jnet, P.s)
    b = ht.monte_carlo_scenarios(3, 8, P.net, P.ts, device="cpu")
    for crit in ("thd", "ieee519"):
        fa, sa = jcap.compliance_fraction(P.jnet, P.jdev, P.s, a,
                                          criterion=crit, thd_limit=0.3)
        fb, sb = ht.compliance_fraction(P.net, P.dev, P.ts, b,
                                        criterion=crit, thd_limit=0.3)
        assert fb == fa
        for x, y in zip(sb, sa):
            _close(x, y, V_TOL)
    kw = dict(thd_limit=0.28, confidence=0.75, lo=1.5, hi=3.0, tol=0.2)
    ja = jcap.find_hosting_capacity(P.jnet, P.jdev, P.s, a, **kw)
    tb = ht.find_hosting_capacity(P.net, P.dev, P.ts, b, **kw)
    assert (tb.feasible, tb.level, tb.levels, tb.fracs, tb.bracket_open) \
        == (ja.feasible, ja.level, ja.levels, ja.fracs, ja.bracket_open)
    assert len(tb.levels) > 2
    with pytest.raises(ValueError):
        ht.compliance_fraction(P.net, P.dev, P.ts, b, criterion="x")


def test_assessment_and_timeseries_match_jax():
    """assess_quantiles on Monte-Carlo draws and run_timeseries over a
    chunked daily profile (net2 H<=5, hpf_sweep), then
    summarize_quantiles, percentile_compliance and
    check_planning_levels; the chunks' results joined field by field
    equal the whole profile solved at once."""
    P = pair("net2", 5)
    a = jcap.monte_carlo_scenarios(5, 8, P.jnet, P.s)
    b = ht.monte_carlo_scenarios(5, 8, P.net, P.ts, device="cpu")
    qa = jst.assess_quantiles(P.jnet, P.jdev, P.s, a)
    qb = ht.assess_quantiles(P.net, P.dev, P.ts, b)
    for f in ("thd_q", "vh_pct_q", "v1_q", "exceed_prob"):
        _close(getattr(qb, f), getattr(qa, f), V_TOL)
    assert (qb.worst_bus, qb.converged_frac, qb.n_samples, qb.quantiles,
            qb.harmonics) == (qa.worst_bus, qa.converged_frac, qa.n_samples,
                              qa.quantiles, qa.harmonics)
    for lv in (None, {3: 0.5, 5: 40.0}):
        pa = jst.check_planning_levels(qa, lv, default_pct=30.0)
        pb = ht.check_planning_levels(qb, lv, default_pct=30.0)
        _close(pb.margin_pct, pa.margin_pct, V_TOL)
        assert (pb.compliant, pb.binding_order, pb.binding_bus) == \
            (pa.compliant, pa.binding_order, pa.binding_bus)
    with pytest.raises(ValueError):
        ht.check_planning_levels(qb, quantile=0.9)

    prof = jst.daily_profile(6, base=0.8, peak=1.1)
    tprof = ht.daily_profile(6, base=0.8, peak=1.1, device="cpu")
    np.testing.assert_array_equal(tprof.numpy(), prof)
    ra = jst.run_timeseries(P.jnet, P.jdev, P.s, prof, inj_profile=prof,
                            chunk=3)
    rb = ht.run_timeseries(P.net, P.dev, P.ts, tprof, inj_profile=tprof,
                           chunk=3)
    same(ra, rb)
    whole = ht.run_timeseries(P.net, P.dev, P.ts, tprof, inj_profile=tprof)
    assert torch.equal(whole.V_m, rb.V_m)
    assert torch.equal(whole.fund.n_iter, rb.fund.n_iter)
    ca = jst.percentile_compliance(ra, P.s, v_kv=10.0)
    cb = ht.percentile_compliance(rb, P.ts, v_kv=10.0)
    for f in ("vh_p", "thd_p", "frac_steps_over"):
        _close(getattr(cb, f), getattr(ca, f), V_TOL)
    assert (cb.compliant, cb.converged_frac, cb.limit_thd) == \
        (ca.compliant, ca.converged_frac, ca.limit_thd)


def test_quantile_reductions_match_jax():
    """summarize_quantiles, percentile_compliance and metric_quantiles on
    a seeded batch with unconverged scenarios (NaN-masked out)."""
    H, n = 4, 4
    jr, tr = _batch(H, n)
    s = hpfx.settings_for_hmax(7)
    ts = ht.settings_for_hmax(7, dtype="float64")
    qs = (0.1, 0.5, 0.95)
    a = jst.summarize_quantiles(jr, s, quantiles=qs, thd_limit=0.1)
    b = ht.summarize_quantiles(tr, ts, quantiles=qs, thd_limit=0.1)
    for f in ("thd_q", "vh_pct_q", "v1_q", "exceed_prob"):
        _close(getattr(b, f), getattr(a, f))
    assert (b.worst_bus, b.converged_frac) == (a.worst_bus, a.converged_frac)
    a = jst.percentile_compliance(jr, s, percentile=90.0)
    b = ht.percentile_compliance(tr, ts, percentile=90.0)
    for f in ("vh_p", "thd_p", "frac_steps_over"):
        _close(getattr(b, f), getattr(a, f))
    assert b.compliant == a.compliant
    jm = jst.metric_quantiles(
        jr, s, lambda m, v: hpfx.results.waveform_metrics(
            m, v, s.harmonics, 256).crest)
    tm = ht.metric_quantiles(
        tr, ts, lambda m, v: ht.waveform_metrics(m, v, ts.harmonics,
                                                 256).crest)
    _close(tm, jm, 1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ht.daily_profile(4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ht.profile_scenarios(ts, [1.0, 1.1])


def test_checkpoint_round_trips_between_packages(solved, tmp_path):
    """An archive written by either package loads in the other: the same
    arrays, fund None; warm_start gives the voltages."""
    P, r = solved
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    hpfx.save_result(jpath, r)
    back = ht.load_result(jpath, device="cpu")
    for k in ("V_m", "V_a", "err", "n_iter", "err_hist", "converged"):
        np.testing.assert_array_equal(to_np(getattr(back, k)),
                                      np.asarray(getattr(r, k)))
    assert back.fund is None
    ht.save_result(tpath, back)
    again = hpfx.load_result(tpath)
    for k in ("V_m", "V_a", "err", "n_iter", "err_hist", "converged"):
        np.testing.assert_array_equal(np.asarray(getattr(again, k)),
                                      np.asarray(getattr(r, k)))
    assert all(torch.equal(x, y) for x, y in zip(ht.warm_start(back),
                                                 (back.V_m, back.V_a)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ht.load_result(jpath)


def test_trajlog_files_equal_jax_bytes(solved, tmp_path):
    """write_vlog and write_ilog of the port equal the JAX writers byte
    for byte on the same trajectory (and with n_iter); the injections of
    trajectory_injections agree to 1e-13; the readers round-trip."""
    P, r = solved
    traj = np.asarray(r.trajectory)
    files = {}
    for tag, fn, arg in (("j", jtl.write_vlog, traj),
                         ("t", ttl.write_vlog, torch.tensor(traj))):
        for n_iter in (None, 2):
            path = tmp_path / f"{tag}{n_iter}_V_log.json"
            files[tag, n_iter] = (fn(str(path), arg, P.s.harmonics,
                                     n_iter=n_iter), path.read_bytes())
    for n_iter in (None, 2):
        assert files["t", n_iter] == files["j", n_iter]
    inj_j = jtl.trajectory_injections(traj, P.jdev, P.jnet.m)
    inj_t = ttl.trajectory_injections(torch.tensor(traj), P.dev, P.net.m)
    _close(inj_t.real, inj_j.real)
    _close(inj_t.imag, inj_j.imag)
    jp, tp = tmp_path / "j_I_log.json", tmp_path / "t_I_log.json"
    assert ttl.write_ilog(str(tp), inj_j[:, 0, :], P.s.harmonics) == \
        jtl.write_ilog(str(jp), inj_j[:, 0, :], P.s.harmonics)
    assert tp.read_bytes() == jp.read_bytes()
    Vm, Va, hs = ttl.read_vlog(str(tmp_path / "tNone_V_log.json"))
    jVm, jVa, jhs = jtl.read_vlog(str(tmp_path / "tNone_V_log.json"))
    np.testing.assert_array_equal(Vm, jVm)
    assert hs == jhs == tuple(P.s.harmonics)
    inj, hs = ttl.read_ilog(str(tp))
    np.testing.assert_array_equal(inj, jtl.read_ilog(str(jp))[0])
    assert os.path.getsize(tp) > 0
