"""The port's design loops against the JAX package, on the CPU in float64:
the Adam of hpfx_torch.optim against optax.adam, optimize_line_params
(taps, reinforcement, bounds), optimize_filter (single, from the
operational resonance, robust over scenarios, a two-branch bank) and the
placement screen and greedy bank planner.

Tolerances: Adam to ADAM_TOL (1e-12) of optax's updates on a fixed
gradient sequence; parameters, objectives and histories within FIT_TOL
(1e-8) of the JAX package's; n_solves, history lengths and NaN positions,
converged/accepted masks and the placement order identical.  Shapes at
H<=9 (the JAX tests' feeders cut from H<=25 where they ran there)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import placement as jpl
from hpfx.network import NONLINEAR, PQ, SLACK
from hpfx.sensitivity import FilterParams as JFP
from hpfx.sensitivity import LineParams as JLP
from hpfx.solve import Scenarios as JScenarios
from hpfx_torch import optim
from hpfx_torch import optimize as topt
from hpfx_torch import placement as tpl

from test_torch_estimate import FIT_TOL, torch_side
from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_sweep_api import pair

#: the port's Adam against optax.adam, relative to the update's scale
ADAM_TOL = 1e-12


def close(got, want, tol=FIT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=0, atol=tol)


@pytest.mark.parametrize("leaves", ["line", "filter"])
def test_adam_matches_optax(leaves):
    """50 steps on a fixed seeded gradient sequence spanning 5 decades,
    over LineParams (3 leaves of (3,)) and FilterParams (2 scalars)."""
    rng = np.random.default_rng(0)
    J, T = (JLP, ht.LineParams) if leaves == "line" else (JFP,
                                                          ht.FilterParams)
    shape = (3,) if leaves == "line" else ()
    p0 = [rng.standard_normal(shape) for _ in J._fields]
    jo, to = optax.adam(0.02), optim.Adam(0.02)
    pj = J(*(jnp.asarray(x) for x in p0))
    pt = T(*(torch.tensor(x) for x in p0))
    sj, st = jo.init(pj), to.init(pt)
    for _ in range(50):
        g = [rng.standard_normal(shape) * 10 ** rng.uniform(-3, 2)
             for _ in J._fields]
        uj, sj = jo.update(J(*(jnp.asarray(x) for x in g)), sj, pj)
        ut, st = to.update(T(*(torch.tensor(x) for x in g)), st, pt)
        for a, b in zip(uj, ut):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=ADAM_TOL * np.abs(a).max())
        pj = J(*(a + b for a, b in zip(pj, uj)))
        pt = T(*(a + b for a, b in zip(pt, ut)))
    assert st.count == 50


@pytest.fixture(scope="module")
def trafo():
    """tests/test_optimize.py's trafo_feeder at H<=9."""
    s = hpfx.settings_for_hmax(9, coupled=True)
    jnet = hpfx.network_from_arrays(
        bus_types=(SLACK, PQ, NONLINEAR),
        components=("generator", "lin_load", "SMPS"),
        P=[0, 100, 250], Q=[0, 50, 100], X_sh=[0.005, 0, 0],
        line_from=[0, 1], line_to=[1, 2], R=[0.5, 1.0], X=[2.0, 4.0],
        tau=[1.05, 1.0], phase_shift=[30.0, 0.0], settings=s,
        per_unit=False)
    jdev = hpfx.load_device_set(jnet, s)
    return (s, jnet, jdev) + torch_side(s, jnet, jdev)


def same_opt(jo, to):
    assert to.n_solves == jo.n_solves
    close(to.history, jo.history)
    for f in ("value", "value0"):
        assert abs(getattr(to, f) - getattr(jo, f)) <= FIT_TOL, f
    for a, b in zip(jo.params, to.params):
        close(b, a)


def _regulation(V_m, V_a):
    return (V_m[0, 1] - 1.0) ** 2


@pytest.mark.parametrize("case", ["tau", "regulation", "z_scale", "bounds"])
def test_optimize_line_params_matches_jax(trafo, case):
    """One free tap (worst THD and the voltage-regulation objective), the
    series-impedance scale, and taps held to a narrow box."""
    s, jnet, jdev, ts, net, dev = trafo
    kw = dict(tau=dict(vary=("tau",), fixed_lines=[1], steps=8,
                       learning_rate=0.01),
              regulation=dict(vary=("tau",), fixed_lines=[1], steps=8,
                              learning_rate=0.01),
              z_scale=dict(vary=("z_scale",), steps=5, learning_rate=0.05,
                           bounds={"z_scale": (0.5, 2.0)}),
              bounds=dict(vary=("tau",), steps=5, learning_rate=0.05,
                          bounds={"tau": (1.0, 1.02)}))[case]
    jf = tf = None
    if case == "regulation":
        jf = lambda vm, va: (vm[0, 1] - 1.0) ** 2  # noqa: E731
        tf = _regulation
    jo = hpfx.optimize_line_params(jnet, jdev, s, functional=jf, **kw)
    to = topt.optimize_line_params(net, dev, ts, functional=tf, **kw)
    same_opt(jo, to)
    for f in ("line_R", "line_X", "line_tau", "line_shift"):
        close(getattr(to.net, f), getattr(jo.net, f))
    assert to.value < to.value0


def test_unknown_vary_leaf_raises(trafo):
    _, _, _, ts, net, dev = trafo
    with pytest.raises(ValueError, match="unknown"):
        topt.optimize_line_params(net, dev, ts, vary=("taps",), steps=1)


@pytest.fixture(scope="module")
def resonant():
    """tests/test_optimize.py's resonant_feeder (passive resonance at
    h = 7) at H<=9."""
    s = hpfx.settings_for_hmax(9, coupled=True)
    X = 0.1
    jnet = hpfx.network_from_arrays(
        bus_types=(SLACK, NONLINEAR), components=("generator", "SMPS"),
        P=[0, 250], Q=[0, 100], line_from=[0], line_to=[1], R=[0.02],
        X=[X], B=[2.0 / (X * 7 ** 2)], settings=s, per_unit=False)
    jdev = hpfx.load_device_set(jnet, s)
    return (s, jnet, jdev) + torch_side(s, jnet, jdev)


@pytest.mark.parametrize("case", ["single", "default_start", "robust_max",
                                  "robust_mean", "bank"])
def test_optimize_filter_matches_jax(resonant, case):
    """A single filter from x_cap 0.05 (10 steps), the default start at
    the operational resonance (no step), one filter over 3 load
    scenarios (max and mean), and a two-branch bank at bus 1."""
    s, jnet, jdev, ts, net, dev = resonant
    kw = dict(bus=1, x_cap0=0.05, steps=10)
    if case == "default_start":
        kw["steps"] = 0
    if case.startswith("robust"):
        p = np.linspace(0.9, 1.1, 3)
        kw.update(steps=4, reduce=case.split("_")[1])
        jkw = dict(kw, scenarios=JScenarios(p_scale=jnp.asarray(p)))
        tkw = dict(kw, scenarios=ht.Scenarios(p_scale=torch.tensor(p)))
    else:
        if case == "bank":
            kw.update(bus=[1, 1], steps=4)
        jkw = tkw = kw
    jo = hpfx.optimize_filter(jnet, jdev, s, **jkw)
    to = topt.optimize_filter(net, dev, ts, **tkw)
    same_opt(jo, to)
    close(to.Y.re, jo.Y.re)
    close(to.Y.im, jo.Y.im)
    if case == "default_start":
        assert to.value == to.value0


def test_filter_sensitivity_in_float32(resonant):
    """A single filter's scalar parameters in float32: torch.func's
    forward mode once gave a 0-d float32 parameter divided by a Python
    float a float64 tangent, and the float32 mismatch raised; the
    float32 gradient lands within 1e-3 of the float64 one."""
    s, jnet, jdev, ts, net, dev = resonant
    grads = {}
    for dt in ("float32", "float64"):
        t = getattr(torch, dt)
        s_ = ts.with_(dtype=dt)
        n_, d_ = net.to(dtype=t), dev.to(dtype=t)
        fp = ht.FilterParams(torch.tensor(6.7, dtype=t),
                             torch.tensor(0.05, dtype=t))
        Y = ht.install_shunt(ht.build_ybus(n_, s_), 1,
                             ht.tuned_filter_admittance(s_, fp.h_tune,
                                                        fp.x_cap))
        res = ht.hpf(n_, d_, s_, Y=Y)
        assert bool(res.converged)
        sens = ht.filter_sensitivity(n_, d_, s_, res, 1, fp)
        assert sens.grad.h_tune.dtype == t
        grads[dt] = np.array([float(g) for g in sens.grad])
    np.testing.assert_allclose(grads["float32"], grads["float64"],
                               rtol=1e-3)


@pytest.fixture(scope="module")
def net2_h5():
    return pair("net2", 5, coupled=True)


def same_report(jr, tr):
    """Two screens agree: masks, grids and order exactly, the numbers to
    FIT_TOL (a candidate's numbers only where it was accepted: an
    unconverged Newton state is where each package's iterations left it,
    and one outside the voltage window is the collapse, |V1| near 0,
    where THD is 0/0 noise)."""
    conv = np.asarray(jr.accepted)
    for f in jr._fields:
        a, b = getattr(jr, f), getattr(tr, f)
        if isinstance(a, str):
            assert a == b
        elif np.asarray(a).dtype.kind in "bi":
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=f)
        elif np.ndim(a) == 1 and f not in ("h_tune", "x_cap"):
            close(b[conv], np.asarray(a)[conv])
        else:
            close(b, a)


@pytest.mark.parametrize("case", ["default", "stable", "collapse",
                                  "objective"])
def test_screen_filter_placement_matches_jax(net2_h5, case):
    """The default grid (every non-slack bus x the dominant orders x 3
    capacitor sizes), the same with the stable mismatch (the stacked line
    structure), tests/test_placement.py's collapse guard, and a custom
    host-side objective on numpy arrays."""
    P = net2_h5 if case != "stable" else pair("net2", 5, coupled=True,
                                              stable_mismatch=True)
    kw = {}
    if case == "collapse":
        kw = dict(buses=[3], h_tunes=[4.85], x_caps=[3e-3, 1.0],
                  v_limits=(0.8, 1.2))
    if case == "objective":
        kw = dict(x_caps=[0.5, 1.0],
                  objective=lambda vm, va: float(np.abs(vm[1:, 3]).sum()))
    jr = jpl.screen_filter_placement(P.jnet, P.jdev, P.s, **kw)
    tr = tpl.screen_filter_placement(P.net, P.dev, P.ts, **kw)
    same_report(jr, tr)
    if case == "collapse":
        assert not tr.accepted[int(np.argmin(tr.x_cap))]
    else:
        assert tr.converged.all() and tr.objective[tr.best] \
            < tr.base_objective


def test_plan_filter_bank_matches_jax(net2_h5):
    P = net2_h5
    kw = dict(n_filters=2, buses=[2, 3], h_tunes=[2.91, 4.85],
              x_caps=[0.5, 1.0])
    jp = jpl.plan_filter_bank(P.jnet, P.jdev, P.s, **kw)
    tp = tpl.plan_filter_bank(P.net, P.dev, P.ts, **kw)
    np.testing.assert_array_equal(tp.buses, jp.buses)
    for f in ("h_tunes", "x_caps", "history"):
        close(getattr(tp, f), getattr(jp, f))
    close(tp.Y_diag.re, jp.Y_diag.re)
    close(tp.Y_diag.im, jp.Y_diag.im)
    assert len(tp.reports) == len(jp.reports)
    for jr, tr in zip(jp.reports, tp.reports):
        same_report(jr, tr)
    stop = tpl.plan_filter_bank(P.net, P.dev, P.ts, n_filters=3, target=1.0,
                                buses=[3], h_tunes=[4.85], x_caps=[1.0])
    assert len(stop.buses) == 0 and stop.history.shape == (1,)


def test_filter_ydiag_and_dominant_orders_match_jax(net2_h5):
    P = net2_h5
    for topo in ("tuned", "highpass", "ctype"):
        yj = jpl.filter_ydiag(P.jnet, P.s, [1, 2, 2], [4.8, 6.7, 2.9],
                              [0.5, 1.0, 2.0], topology=topo)
        yt = tpl.filter_ydiag(P.net, P.ts, [1, 2, 2], [4.8, 6.7, 2.9],
                              [0.5, 1.0, 2.0], topology=topo)
        close(yt.re, yj.re, 1e-12 * np.abs(np.asarray(yj.re)).max())
        close(yt.im, yj.im, 1e-12 * np.abs(np.asarray(yj.im)).max())
    np.testing.assert_array_equal(
        tpl.dominant_orders(P.net, P.dev, P.ts, k=2),
        jpl.dominant_orders(P.jnet, P.jdev, P.s, k=2))
    with pytest.raises(ValueError, match="topology"):
        tpl.screen_filter_placement(P.net, P.dev, P.ts, topology="bandstop")
