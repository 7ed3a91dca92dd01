"""The port's contingency screens against the JAX package, on the CPU in
float64, and the two sums repaired for determinism on the card.

- the zeroed-line outage build (hpfx_torch.contingency.outage_ybus)
  against the L−1-line build, for every outage of net1;
- ybus.stable_matvec and the fused trip's plain sum, now an incidence
  product, against their former index_add forms and JAX's stable_matvec;
- the dense Jacobian's Norton adds write distinct positions (so its
  index_add_ adds no repeats);
- screen_line_outages_sweep (with and without the float64 verification),
  screen_line_outages, screen_shunt_outages, screen_device_outages and
  outage_impedance_shift against the JAX package.

The (outage × draw) screen runs on net1 H<=5 uncoupled with line 20 (the
ring's closing line, bus 20 to bus 1) removed, so that five lines are
bridges and the islanded rows are exercised.  Both reference defects
(ROADMAP §3) are gated around: the intact baseline is checked to
converge here, and the float64 verification is held to the JAX
package's labels, each pair after one cold start in both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import contingency as jc
from hpfx.ybus import stable_matvec as j_stable_matvec
from hpfx_torch import contingency as tc
from hpfx_torch import cx, ybus
from hpfx_torch.cx import Cx
from hpfx_torch.harmonic import _jacobian_map

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_net1 import VM_TOL_F64 as NET1_TOL
from test_torch_sweep_api import V_TOL, pair, scenarios, to_np

#: the repaired sums against their former forms, relative to the
#: largest magnitude of the result
SUM_RTOL = 1e-15
#: the ring's closing line of net1 (bus 20 to bus 1)
RING_CLOSE = 19


def _index_add_matvec(lineY, V_m, V_a):
    """ybus.stable_matvec as it summed before: index_add into buses."""
    f, t = lineY.f_idx, lineY.t_idx
    flow_f = lineY.Ys * ybus._polar_diff(
        V_m[..., f] * lineY.a_ff, V_a[..., f], V_m[..., t] * lineY.inv_tau,
        V_a[..., t] + lineY.shift)
    flow_t = lineY.Ys * ybus._polar_diff(
        V_m[..., t], V_a[..., t], V_m[..., f] * lineY.inv_tau,
        V_a[..., f] - lineY.shift)
    out = lineY.d * cx.polar(V_m, V_a)
    add = lambda o, i, v: o.index_add(-1, i, v)
    return Cx(add(add(out.re, f, flow_f.re), t, flow_t.re),
              add(add(out.im, f, flow_f.im), t, flow_t.im))


def _rel(a, b):
    a, b = to_np(a), to_np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _voltages(H, n, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.02, 1.1, (B, H, n)),
            rng.uniform(0.0, 2 * np.pi, (B, H, n)))


@pytest.mark.parametrize("name", ["net1", "net2", "net3"])
def test_stable_matvec_incidence_sum(name):
    """The incidence-product sum of ybus.stable_matvec against its former
    index_add form (1e-15 of the result's scale) and JAX's
    stable_matvec."""
    P = pair(name, 25, stable_mismatch=True)
    lineY = ybus.build_line_ybus(P.net, P.ts)
    Vm, Va = _voltages(P.ts.n_harmonics, P.net.n, 5, 4)
    got = ybus.stable_matvec(lineY, torch.tensor(Vm), torch.tensor(Va))
    old = _index_add_matvec(lineY, torch.tensor(Vm), torch.tensor(Va))
    jline = hpfx.ybus.build_line_ybus(P.jnet, P.s)
    want = [j_stable_matvec(jline, jnp.asarray(m), jnp.asarray(a))
            for m, a in zip(Vm, Va)]
    for part in ("re", "im"):
        assert _rel(getattr(got, part), getattr(old, part)) <= SUM_RTOL
        assert _rel(getattr(got, part),
                    np.stack([getattr(w, part) for w in want])) <= 1e-14


def test_fused_trip_plain_sum():
    """fused_trip._stable_matvec (under fused_trip_ref) sums the line
    flows by the incidence product: within 1e-15 of its former index_add
    form and of ybus.stable_matvec on the same voltages."""
    from hpfx_torch import fused_trip as ft
    P = pair("net2", 25, stable_mismatch=True)
    Y = ht.build_ybus(P.net, P.ts)
    lineY = ybus.build_line_ybus(P.net, P.ts)
    dims, k = ft.make_trip_consts(Y, lineY, P.dev, P.net, P.ts,
                                  dtype=torch.float64)
    Vm, Va = _voltages(P.ts.n_harmonics, P.net.n, 6, 5)
    lane = lambda a: torch.tensor(a).permute(1, 2, 0)            # (H, n, B)
    got = ft._stable_matvec(k, lane(Vm), lane(Va))
    old = _index_add_matvec(lineY, torch.tensor(Vm), torch.tensor(Va))
    ref = ybus.stable_matvec(lineY, torch.tensor(Vm), torch.tensor(Va))
    for g, o, r in zip(got, old, ref):
        g = g.permute(2, 0, 1)
        assert _rel(g, o) <= SUM_RTOL
        assert _rel(g, r) <= SUM_RTOL


@pytest.mark.parametrize("shape", [(3, 4, 3, 1), (13, 4, 3, 2),
                                   (3, 20, 13, 1)])
def test_jacobian_adds_are_distinct(shape):
    """Every Norton add of the dense Jacobian writes distinct positions,
    so its index_add_ (harmonic.build_harmonic_jacobian) adds no repeats
    and its order does not matter on any device."""
    mp = _jacobian_map(*shape, torch.device("cpu"))
    for _, _, dst in mp.adds:
        assert dst.unique().numel() == dst.numel()


def test_outage_build_is_the_removed_line_build():
    """For every single-line outage of net1, the zeroed build (all L lines
    kept) equals the L−1-line build: the dense admittances exactly, the
    stable matvec within 1e-15 of its scale."""
    P = pair("net1", 5, coupled=False, stable_mismatch=True)
    L = P.net.line_from.shape[0]
    Y, lineY, lineY_f = tc.outage_ybus(P.net, P.ts, range(L))
    Vm, Va = (torch.tensor(a[0]) for a in _voltages(P.ts.n_harmonics,
                                                    P.net.n, 1, 6))
    for k in range(L):
        net_k = tc._without_line(P.net, k)
        Yk = ht.build_ybus(net_k, P.ts)
        assert torch.equal(Y.re[k], Yk.re) and torch.equal(Y.im[k], Yk.im)
        lk = ybus.build_line_ybus(net_k, P.ts)
        mine = lineY._replace(Ys=lineY.Ys[k], d=lineY.d[k])
        got = ybus.stable_matvec(mine, Vm, Va)
        want = ybus.stable_matvec(lk, Vm, Va)
        assert _rel(got.re, want.re) <= SUM_RTOL
        assert _rel(got.im, want.im) <= SUM_RTOL
        assert torch.equal(lineY_f.d[k].re, lineY.d[k].re[:1])


def _ring_open(P):
    """Both packages' net1 with the ring's closing line removed."""
    keep = np.arange(P.net.line_from.shape[0]) != RING_CLOSE
    jnet = dataclasses.replace(P.jnet, **{
        f: jnp.asarray(np.asarray(getattr(P.jnet, f))[keep])
        for f in tc._LINE_FIELDS})
    return jnet, tc._without_line(P.net, RING_CLOSE)


@pytest.mark.parametrize("verify", [False, True],
                         ids=["screen", "verified"])
def test_screen_line_outages_sweep_matches_jax(verify):
    """The (outage × draw) screen on net1 H<=5 uncoupled with the ring
    open, over 6 outages (two of them bridges) and 4 draws: the same
    islanded rows, converged flags, counts and ranking; worst THD within
    test_torch_net1.py's float64 bound; with ``verify_infeasible`` the
    same infeasible pairs as the JAX package's float64 pass."""
    P = pair("net1", 5, coupled=False, stable_mismatch=True)
    jnet, net = _ring_open(P)
    isl = tc.islanded_lines(net)
    np.testing.assert_array_equal(isl, jc.islanded_lines(jnet))
    outs = [0, 5, 18, 20, 21] + [int(np.flatnonzero(isl)[0])]
    js, ts = scenarios(np.linspace(0.9, 1.1, 4), np.linspace(0.9, 1.1, 4),
                       np.linspace(0.8, 1.3, 4))
    assert bool(ht.hpf_sweep(net, P.dev, P.ts, ts).converged.all())
    a = jc.screen_line_outages_sweep(jnet, P.jdev, P.s, js, outages=outs,
                                     verify_infeasible=verify)
    b = tc.screen_line_outages_sweep(net, P.dev, P.ts, ts, outages=outs,
                                     verify_infeasible=verify)
    assert b.outages == a.outages and b.islanded[-1]
    for f in ("islanded", "converged", "n_iter", "infeasible", "ranking"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    assert not b.converged.all()
    ok = a.converged
    np.testing.assert_allclose(b.worst_thd[ok], a.worst_thd[ok], rtol=0,
                               atol=NET1_TOL)
    np.testing.assert_allclose(b.base_worst, a.base_worst, rtol=0,
                               atol=NET1_TOL)
    np.testing.assert_allclose(b.delta_q, a.delta_q, rtol=0, atol=NET1_TOL)
    np.testing.assert_array_equal(b.conv_frac, a.conv_frac)


def test_single_case_screens_match_jax():
    """screen_line_outages on net3 H<=5 (every line), screen_shunt_outages
    (the slack's shunt) and outage_impedance_shift (every line) on net2
    H<=5: the JAX package's flags and counts, THD within 1e-10 and
    impedances within 1e-12."""
    P = pair("net3", 5)
    a = jc.screen_line_outages(P.jnet, P.jdev, P.s)
    b = tc.screen_line_outages(P.net, P.dev, P.ts)
    for f in ("islanded", "converged", "n_iter", "ranking"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for f in ("thd", "base_thd", "worst_thd", "v1_min"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0,
                                   atol=V_TOL)
    Q = pair("net2", 5)
    a = jc.screen_shunt_outages(Q.jnet, Q.jdev, Q.s)
    b = tc.screen_shunt_outages(Q.net, Q.dev, Q.ts)
    assert b.outages == a.outages == (0,)
    np.testing.assert_array_equal(b.converged, a.converged)
    np.testing.assert_array_equal(b.n_iter, a.n_iter)
    np.testing.assert_allclose(b.thd, a.thd, rtol=0, atol=V_TOL)
    a = jc.outage_impedance_shift(Q.jnet, Q.jdev, Q.s)
    b = tc.outage_impedance_shift(Q.net, Q.dev, Q.ts)
    scale = np.abs(a.zmag).max()
    np.testing.assert_allclose(b.zmag, a.zmag, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(b.amplification, a.amplification, rtol=1e-12)
    for f in ("shift_order", "shift_bus", "ranking"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_device_outages_match_jax():
    """device_outage_scenarios and screen_device_outages on net1 H<=5
    uncoupled (seven devices), against the JAX package's; the scenarios
    go to the card unless a device is named."""
    P = pair("net1", 5, coupled=False)
    js, jsel = jc.device_outage_scenarios(P.jnet, P.s, devices_out=[1, 4])
    ts, tsel = tc.device_outage_scenarios(P.net, P.ts, devices_out=[1, 4],
                                          device="cpu")
    assert tsel == jsel
    np.testing.assert_array_equal(ts.injection_scale.numpy(),
                                  np.asarray(js.injection_scale))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.device_outage_scenarios(P.net, P.ts)
    a = jc.screen_device_outages(P.jnet, P.jdev, P.s, devices_out=[1, 4])
    b = tc.screen_device_outages(P.net, P.dev, P.ts, devices_out=[1, 4])
    np.testing.assert_array_equal(b.converged, a.converged)
    np.testing.assert_array_equal(b.n_iter, a.n_iter)
    np.testing.assert_allclose(b.thd, a.thd, rtol=0, atol=NET1_TOL)
