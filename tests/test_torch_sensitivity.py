"""The port's impedance analysis and implicit-function-theorem
sensitivities against the JAX package, on the CPU in float64.

impedance: the nodal scans (passive, and operational with the slack
grounded or not), driving-point magnitudes, resonance peaks, the three filter
admittances (single and banks) and their installation, the off-grid
frequency scan (interpolated Norton diagonals) and the per-device
distortion contributions, to 1e-12 of their scale.

sensitivity: every entry point on net2 H<=5 (B <= 4 for the sweep
forms), against the JAX package's or, for sweep_filter_sensitivity, the
port's single-case form at each scenario; the arrow and the dense
column solves against each other: gradients to rtol 1e-8 (GRAD_RTOL) of the JAX
package's and state sensitivities to 1e-8 of their scale.  The port
differentiates the mismatch with torch.func (jacfwd under vmap) and
solves the stacked columns once, outside any transform.  The JAX
package's entry points run under ``jax.jit`` here, as bench.py runs
them: one compiled program instead of an eager op-by-op trace."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import impedance as jimp
from hpfx import sensitivity as jsn
from hpfx_torch import impedance as timp
from hpfx_torch import sensitivity as tsn
from hpfx_torch.cx import Cx

from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_sweep_api import LIBRARY, pair, scenarios, to_np

#: the JAX package's gradients, relative
GRAD_RTOL = 1e-8
#: the impedance scans, relative to their scale
Z_RTOL = 1e-12


def _close(got, want, rtol):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _cx(got, want, rtol=Z_RTOL):
    _close(got.re, want.re, rtol)
    _close(got.im, want.im, rtol)


def _grads(got, want, rtol=GRAD_RTOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("name", ["net2", "net3"])
def test_impedance_scans_match_jax(name):
    """impedance_scan (passive, and operational with the slack grounded
    or not), driving_point_impedance, resonance_peaks, frequency_scan on
    a fractional grid and distortion_contributions."""
    P = pair(name, 13, coupled=True)
    # the passive network with the slack ungrounded is singular
    for jd, td, grounded in ((None, None, True), (P.jdev, P.dev, True),
                             (P.jdev, P.dev, False)):
        _cx(timp.impedance_scan(P.net, P.ts, devices=td,
                                ground_slack=grounded),
            jimp.impedance_scan(P.jnet, P.s, devices=jd,
                                ground_slack=grounded))
    zj = jimp.driving_point_impedance(P.jnet, P.s, devices=P.jdev)
    zt = timp.driving_point_impedance(P.net, P.ts, devices=P.dev)
    _close(zt, zj, Z_RTOL)
    for a, b in zip(timp.resonance_peaks(zt, P.ts),
                    jimp.resonance_peaks(zj, P.s)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b)) \
            if np.asarray(b).dtype != np.float64 else _close(a, b, Z_RTOL)
    grid = np.linspace(0.5, 14.0, 40)
    for dev in (None, "dev"):
        jd, td = (None, None) if dev is None else (P.jdev, P.dev)
        _close(timp.frequency_scan(P.net, P.ts, grid, devices=td),
               jimp.frequency_scan(P.jnet, P.s, grid, devices=jd), Z_RTOL)
    _cx(timp.distortion_contributions(P.net, P.dev, P.ts),
        jimp.distortion_contributions(P.jnet, P.jdev, P.s))


def test_filters_and_shunts_match_jax():
    """The tuned, high-pass and C-type filter admittances (one branch and
    a bank), install_shunt and install_shunts (a repeated bus
    accumulates); plain numbers go to the card unless a device is
    named."""
    P = pair("net2", 13)
    bank_j = (jnp.asarray([5.0, 7.0, 11.0]), jnp.asarray([2.0, 3.0, 4.0]))
    bank_t = tuple(torch.tensor(np.asarray(x)) for x in bank_j)
    for jfun, tfun in ((jimp.tuned_filter_admittance,
                        timp.tuned_filter_admittance),
                       (jimp.highpass_filter_admittance,
                        timp.highpass_filter_admittance),
                       (jimp.ctype_filter_admittance,
                        timp.ctype_filter_admittance)):
        _cx(tfun(P.ts, 7.0, 2.5, device="cpu"), jfun(P.s, 7.0, 2.5))
        _cx(tfun(P.ts, *bank_t), jfun(P.s, *bank_j))
    Y = ht.build_ybus(P.net, P.ts)
    jY = hpfx.build_ybus(P.jnet, P.s)
    yf_j = jimp.tuned_filter_admittance(P.s, *bank_j)
    yf_t = timp.tuned_filter_admittance(P.ts, *bank_t)
    _cx(timp.install_shunt(Y, 2, yf_t[0]), jimp.install_shunt(jY, 2, yf_j[0]))
    _cx(timp.install_shunts(Y, [2, 3, 2], yf_t),
        jimp.install_shunts(jY, [2, 3, 2], yf_j))
    _cx(timp.impedance_scan(P.net, P.ts, Y=timp.install_shunt(Y, 2, yf_t[0])),
        jimp.impedance_scan(P.jnet, P.s, Y=jimp.install_shunt(jY, 2, yf_j[0])))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timp.tuned_filter_admittance(P.ts, 7.0, 2.5)


def test_scenario_sensitivities_match_jax():
    """scenario_sensitivity (per-bus loads, per-device injections),
    injection_sensitivity (scalar) and line_sensitivity at a converged
    net2 H<=5 solution, the dense Jacobian solved; the arrow solve of the
    same columns agrees."""
    P = pair("net2", 5)
    jr, tr = hpfx.hpf(P.jnet, P.jdev, P.s), ht.hpf(P.net, P.dev, P.ts)
    n, nl = P.net.n, P.net.n_nonlinear
    jp = jsn.ScenarioParams(jnp.ones(n), 1.0, jnp.ones(nl))
    tp = tsn.ScenarioParams(torch.ones(n, dtype=torch.float64), 1.0,
                            torch.ones(nl, dtype=torch.float64))
    a = jax.jit(lambda r, p: jsn.scenario_sensitivity(
        P.jnet, P.jdev, P.s, r, params=p))(jr, jp)
    b = tsn.scenario_sensitivity(P.net, P.dev, P.ts, tr, params=tp)
    _grads(b.grad, a.grad)
    _close(b.value, a.value, GRAD_RTOL)
    _close(b.dx, a.dx, GRAD_RTOL)
    c = tsn.scenario_sensitivity(P.net, P.dev, P.ts.with_(solver="arrow"),
                                 tr, params=tp)
    _grads(c.grad, b.grad)
    a = jax.jit(lambda r: jsn.injection_sensitivity(
        P.jnet, P.jdev, P.s, r))(jr)
    b = tsn.injection_sensitivity(P.net, P.dev, P.ts, tr)
    _grads([b.grad], [a.grad])
    _close(b.dx, a.dx, GRAD_RTOL)
    a = jax.jit(lambda r: jsn.line_sensitivity(P.jnet, P.jdev, P.s, r))(jr)
    b = tsn.line_sensitivity(P.net, P.dev, P.ts, tr)
    _grads(b.grad, a.grad)


def test_sweep_sensitivity_matches_jax():
    """sweep_sensitivity over a B=4 net2 H<=5 sweep (per-scenario p, q
    and injection) with the arrow solver against the JAX package's; the
    dense solve of the same columns, and scenario_sensitivity of each
    scenario, agree with it."""
    P = pair("net2", 5, solver="arrow")
    B = 4
    js, ts = scenarios(np.linspace(0.85, 1.15, B), np.linspace(0.9, 1.1, B),
                       np.linspace(0.7, 1.3, B))
    jr = hpfx.solve.hpf_sweep(P.jnet, P.jdev, P.s, js)
    tr = ht.hpf_sweep(P.net, P.dev, P.ts, ts)
    a = jax.jit(lambda r, sc: jsn.sweep_sensitivity(
        P.jnet, P.jdev, P.s, r, sc))(jr, js)
    b = tsn.sweep_sensitivity(P.net, P.dev, P.ts, tr, ts)
    _grads(b.grad, a.grad)
    _close(b.value, a.value, GRAD_RTOL)
    _close(b.dx, a.dx, GRAD_RTOL)
    c = tsn.sweep_sensitivity(P.net, P.dev, P.ts.with_(solver="dense"), tr,
                              ts)
    _grads(c.grad, b.grad)
    for i in range(B):
        one = ht.HPFResult(*(x[i] for x in tr[:6]))
        d = tsn.scenario_sensitivity(
            P.net, P.dev, P.ts, one,
            params=tsn.ScenarioParams(*(x[i] for x in ts[:3])))
        _grads(d.grad, [g[i] for g in b.grad])


def test_filter_sensitivities_match_jax():
    """filter_sensitivity of a two-branch bank on net2 H<=5 solved with
    the bank in service, against the JAX package's; each scenario of
    sweep_filter_sensitivity (B=3, one shared filter) agrees with
    filter_sensitivity at that scenario."""
    P = pair("net2", 5)
    Y0j, Y0t = hpfx.build_ybus(P.jnet, P.s), ht.build_ybus(P.net, P.ts)
    h, x, bus = [5.0, 7.0], [3.0, 2.0], [2, 3]
    jf = jsn.FilterParams(jnp.asarray(h), jnp.asarray(x))
    tf = tsn._params(tsn.FilterParams(h, x), torch.float64, "cpu")
    jr = hpfx.hpf(P.jnet, P.jdev, P.s,
                  Y=jsn._filter_Y(Y0j, P.s, bus, jf, 30.0))
    tr = ht.hpf(P.net, P.dev, P.ts, Y=tsn._filter_Y(Y0t, P.ts, bus, tf, 30.0))
    a = jax.jit(lambda r, f: jsn.filter_sensitivity(
        P.jnet, P.jdev, P.s, r, bus, f))(jr, jf)
    b = tsn.filter_sensitivity(P.net, P.dev, P.ts, tr, bus, tf)
    _grads(b.grad, a.grad)
    _close(b.dx, a.dx, GRAD_RTOL)

    B = 3
    _, ts = scenarios(np.linspace(0.9, 1.1, B), None, np.linspace(0.8, 1.2, B))
    tf = tsn._params(tsn.FilterParams(7.0, 2.0), torch.float64, "cpu")
    Yf = tsn._filter_Y(Y0t, P.ts, 2, tf, 30.0)
    tr = ht.hpf_sweep(P.net, P.dev, P.ts, ts, Y=Yf)
    b = tsn.sweep_filter_sensitivity(P.net, P.dev, P.ts, tr, ts, 2, tf)
    assert tuple(b.dx.shape[::2]) == (B, 2)
    for i in range(B):
        one = ht.HPFResult(*(x[i] for x in tr[:6]))
        d = tsn.filter_sensitivity(
            P.net, P.dev, P.ts, one, 2, tf,
            scenario_params=tsn.ScenarioParams(ts.p_scale[i], ts.p_scale[i],
                                               ts.injection_scale[i]))
        _grads(d.grad, [g[i] for g in b.grad])


def test_mix_sensitivity_matches_jax():
    """mix_sensitivity of a three-type library's weights at a converged
    net2 H<=5 mix solve, against the JAX package's."""
    P = pair("net2", 5)
    jlib = hpfx.load_device_library(LIBRARY, P.s)
    tlib = ht.load_device_library(LIBRARY, P.ts, device="cpu")
    w = np.array([[0.5, 0.3, 0.2]])
    jr = hpfx.hpf(P.jnet, jlib.mixed(jnp.asarray(w)), P.s)
    tr = ht.hpf(P.net, tlib.mixed(torch.tensor(w)), P.ts)
    a = jax.jit(lambda r, w_: jsn.mix_sensitivity(
        P.jnet, jlib, P.s, r, w_))(jr, jnp.asarray(w))
    b = tsn.mix_sensitivity(P.net, tlib, P.ts, tr, w)
    _grads([b.grad], [a.grad])
    _close(b.dx, a.dx, GRAD_RTOL)
