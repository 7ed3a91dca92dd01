"""The port's inverse problems against the JAX package, on the CPU in
float64: harmonic source estimation (estimate_injections with a DeviceSet
and with a DeviceLibrary, estimate_background) and active-filter sizing
(size_active_filter), on the same inputs and measurements.

Tolerances: fitted scales, backgrounds, spectra, misfits and the
validating solves' voltages within FIT_TOL (1e-8) of the JAX package's;
n_solves, history lengths and their NaN (rejected step) positions
identical.  The JAX tests of these modules are slow, so these files are
their tier-1 cover: shapes at H<=9 and net1 at H<=5; the JAX entry points
jit their own solves."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx.activefilter import size_active_filter as j_size
from hpfx.network import NONLINEAR, PQ, SLACK
from hpfx_torch import activefilter as taf
from hpfx_torch import estimate as tes

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_sweep_api import pair

#: fitted parameters, misfits and voltages against the JAX package's
FIT_TOL = 1e-8


def torch_side(s, jnet, jdev):
    """The port's settings (float64), network and devices on the CPU from
    the JAX package's, bit for bit."""
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    return ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64"), \
        net, dev


def feeder(h_max=9, **kw):
    """tests/test_estimate.py's two_smps_feeder: slack - PQ - SMPS - SMPS,
    thresh_h 1e-8; (JAX settings, net, devices, port settings, net,
    devices)."""
    s = hpfx.settings_for_hmax(h_max, coupled=True, thresh_h=1e-8, **kw)
    jnet = hpfx.network_from_arrays(
        bus_types=(SLACK, PQ, NONLINEAR, NONLINEAR),
        components=("generator", "lin_load", "SMPS", "SMPS"),
        P=[0, 100, 250, 150], Q=[0, 50, 100, 60],
        line_from=[0, 1, 2], line_to=[1, 2, 3],
        R=[0.4, 0.8, 1.2], X=[1.5, 3.0, 4.5],
        settings=s, per_unit=False)
    jdev = hpfx.load_device_set(jnet, s)
    return (s, jnet, jdev) + torch_side(s, jnet, jdev)


@pytest.fixture(scope="module")
def two_smps():
    return feeder()


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_fit(jo, to, tol=FIT_TOL):
    """Two LM fits agree: counts and rejected steps exactly, the numbers
    to ``tol``."""
    assert to.n_solves == jo.n_solves
    jh, th = np.asarray(jo.history), np.asarray(to.history)
    assert th.shape == jh.shape
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    np.testing.assert_allclose(th[~np.isnan(th)], jh[~np.isnan(jh)],
                               rtol=0, atol=tol)
    for f in ("misfit", "misfit0"):
        assert abs(getattr(to, f) - getattr(jo, f)) <= tol, f
    np.testing.assert_allclose(to_np(to.result.V_m),
                               np.asarray(jo.result.V_m), rtol=0, atol=tol)


def _truth(S, scales):
    s, jnet, jdev = S[:3]
    res = hpfx.hpf(jnet, jdev.scale(jnp.asarray(scales, s.real_dtype)), s)
    assert bool(res.converged)
    return np.asarray(res.V_m)


def _injection_case(S, case):
    """(true scales, measurements, keyword arguments) of one case of
    tests/test_estimate.py."""
    if case == "full":
        return [0.7, 1.3], _truth(S, [0.7, 1.3]), {}
    if case == "remote":
        V = _truth(S, [1.2, 0.6])
        part = np.zeros_like(V)
        part[:, 1] = V[:, 1]
        return [1.2, 0.6], part, dict(buses=[1])
    if case == "load_level":
        s, jnet, jdev = S[:3]
        net_l = dataclasses.replace(jnet, bus_P=jnet.bus_P * 1.15,
                                    bus_Q=jnet.bus_Q * 1.15)
        res = hpfx.hpf(net_l, jdev.scale(jnp.asarray([0.9, 1.1])), s)
        return [0.9, 1.1], np.asarray(res.V_m), dict(p_scale=1.15,
                                                     q_scale=1.15)
    if case == "noise":
        V = _truth(S, [0.8, 1.2])
        rng = np.random.default_rng(11)
        return [0.8, 1.2], V * (1.0 + 0.01 * rng.standard_normal(V.shape)), \
            dict(weights="relative")
    assert case == "bounds"
    return None, _truth(S, [1.0, 1.0]), dict(scales0=5.0, bounds=(0.2, 1.5),
                                             steps=3)


@pytest.mark.parametrize("case", ["full", "remote", "load_level", "noise",
                                  "bounds"])
def test_estimate_injections_matches_jax(two_smps, case):
    """Full observation, the device-free bus alone, a known 1.15x load
    level, 1% multiplicative noise with relative weights, and a start
    projected onto tight bounds."""
    s, jnet, jdev, ts, net, dev = two_smps
    true, V, kw = _injection_case(two_smps, case)
    kw.setdefault("scales0", 1.0)
    jo = hpfx.estimate_injections(jnet, jdev, s, jnp.asarray(V), **kw)
    to = tes.estimate_injections(net, dev, ts, V, **kw)
    same_fit(jo, to)
    np.testing.assert_allclose(to.scales.numpy(), np.asarray(jo.scales),
                               rtol=0, atol=FIT_TOL)
    if case in ("full", "remote", "load_level"):
        np.testing.assert_allclose(to.scales.numpy(), true, atol=1e-4)


def test_mix_estimation_matches_jax(two_smps):
    """A DeviceLibrary fits the (n_nl, T) mix weights."""
    s, jnet, jdev, ts, net, dev = two_smps
    jlib = hpfx.load_device_library(("SMPS", "ev_1"), s)
    lib = ht.load_device_library(("SMPS", "ev_1"), ts, device="cpu")
    w = np.asarray([[1.0, 0.0], [0.4, 0.8]])
    V = np.asarray(hpfx.hpf(jnet, jlib.mixed(jnp.asarray(w)), s).V_m)
    jo = hpfx.estimate_injections(jnet, jlib, s, jnp.asarray(V),
                                  scales0=0.5)
    to = tes.estimate_injections(net, lib, ts, V, scales0=0.5)
    assert to.scales.shape == (2, 2)
    same_fit(jo, to)
    np.testing.assert_allclose(to.scales.numpy(), np.asarray(jo.scales),
                               rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(to.scales.numpy(), w, atol=1e-4)


def test_seven_sources_net1_matches_jax():
    """net1's seven device levels from full observation at H<=5
    (uncoupled: the coupled net1 H<=5 case is the reference's DIVERGED
    fixture)."""
    P = pair("net1", 5, coupled=False, thresh_h=1e-8)
    true = np.random.default_rng(7).uniform(0.6, 1.4, P.jnet.n_nonlinear)
    res = hpfx.hpf(P.jnet, P.jdev.scale(jnp.asarray(true)), P.s)
    assert bool(res.converged)
    jo = hpfx.estimate_injections(P.jnet, P.jdev, P.s, res.V_m, scales0=1.0)
    to = tes.estimate_injections(P.net, P.dev, P.ts, np.asarray(res.V_m),
                                 scales0=1.0)
    same_fit(jo, to)
    np.testing.assert_allclose(to.scales.numpy(), np.asarray(jo.scales),
                               rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(to.scales.numpy(), true, atol=1e-5)


@pytest.fixture(scope="module")
def net2_h9():
    return pair("net2", 9, coupled=True)


@pytest.mark.parametrize("case", ["full", "partial", "noise"])
def test_estimate_background_matches_jax(net2_h9, case):
    """The complex 5th/7th Thevenin spectrum behind the slack from |V|
    meters: every bus, the slack and bus 1 only, and 1% relative noise
    with relative weights."""
    P = net2_h9
    spec = {5: (0.02, 0.4), 7: (0.012, -1.1)}
    I_bg = hpfx.background_from_harmonics(P.jnet, P.s, spec)
    V = np.asarray(hpfx.hpf(P.jnet, P.jdev, P.s, I_bg=I_bg).V_m)
    kw = dict(orders=(5, 7))
    if case == "partial":
        kw["buses"] = [0, 1]
    if case == "noise":
        rng = np.random.default_rng(3)
        V = V * (1 + 0.01 * rng.standard_normal(V.shape))
        kw["weights"] = "relative"
    jo = hpfx.estimate_background(P.jnet, P.jdev, P.s, V, **kw)
    to = tes.estimate_background(P.net, P.dev, P.ts, V, **kw)
    same_fit(jo, to)
    assert to.orders == jo.orders
    np.testing.assert_allclose(to.v_bg, jo.v_bg, rtol=0, atol=FIT_TOL)
    if case == "full":    # recovered to the truth solve's NR tolerance
        for h, (m_h, a_h) in spec.items():
            assert abs(to.v_bg[to.orders.index(h)]
                       - m_h * np.exp(1j * a_h)) < 1e-6


def test_background_as_current_matches_jax(two_smps):
    """as_current=True fits the injected Norton spectrum at bus 1."""
    s, jnet, jdev, ts, net, dev = two_smps
    i_true = 0.3 * np.exp(0.7j)
    I_bg = hpfx.background_from_harmonics(
        jnet, s, {5: (abs(i_true), float(np.angle(i_true)))}, bus=1,
        as_current=True)
    V = np.asarray(hpfx.hpf(jnet, jdev, s, I_bg=I_bg).V_m)
    kw = dict(orders=(5,), bus=1, as_current=True, bound=0.5)
    jo = hpfx.estimate_background(jnet, jdev, s, V, **kw)
    to = tes.estimate_background(net, dev, ts, V, **kw)
    same_fit(jo, to)
    np.testing.assert_allclose(to.v_bg, jo.v_bg, rtol=0, atol=FIT_TOL)
    assert abs(to.v_bg[0] - i_true) < 1e-7


def test_background_order_validation(net2_h9):
    P = net2_h9
    V = np.ones((P.ts.n_harmonics, P.net.n))
    for orders in ((1,), (4,), (11,)):
        with pytest.raises(ValueError, match="not fittable"):
            tes.estimate_background(P.net, P.dev, P.ts, V, orders=orders)


def same_sizing(jo, to, single=True):
    for f in ("I_c", "I_bg"):
        for part in ("re", "im"):
            np.testing.assert_allclose(
                getattr(getattr(to, f), part).numpy(),
                np.asarray(getattr(getattr(jo, f), part)), rtol=0,
                atol=FIT_TOL)
    for f in ("rating_rms", "thd_before", "thd_after"):
        np.testing.assert_allclose(getattr(to, f), getattr(jo, f), rtol=0,
                                   atol=FIT_TOL)
        assert np.ndim(getattr(to, f)) == (0 if single else 1)
    assert to.n_solves == jo.n_solves
    assert abs(to.misfit - jo.misfit) <= FIT_TOL
    np.testing.assert_allclose(to.result.V_m.numpy(),
                               np.asarray(jo.result.V_m), rtol=0,
                               atol=FIT_TOL)


@pytest.mark.parametrize("case", ["full", "partial", "bank"])
def test_size_active_filter_matches_jax(net2_h9, case):
    """Every order at bus 3, the 5th/7th pair only (exact zeros at the
    other orders), and a co-sized bank at buses 2 and 3."""
    P = net2_h9
    kw = dict(bus=3, residual=0.05)
    if case == "partial":
        kw["orders"] = [5, 7]
    if case == "bank":
        kw["bus"] = [2, 3]
    jo = j_size(P.jnet, P.jdev, P.s, **kw)
    to = taf.size_active_filter(P.net, P.dev, P.ts, **kw)
    same_sizing(jo, to, single=case != "bank")
    if case == "partial":
        hs = list(P.ts.harmonics)
        ic = np.abs(to.I_c.re.numpy() + 1j * to.I_c.im.numpy())
        mask = np.ones(len(hs), bool)
        mask[[0, hs.index(5), hs.index(7)]] = False
        assert ic[mask].max() == 0.0
    else:
        assert np.all(to.thd_after < 0.1 * np.asarray(to.thd_before))


def test_active_filter_linear_devices_matches_jax():
    """A six-pulse converter (constant injections, uncoupled) from its
    exact linear seed: the sizing is linear and lands in few solves."""
    s = hpfx.settings_for_hmax(9, coupled=False)
    kw = dict(bus_types=(SLACK, PQ, NONLINEAR),
              components=("generator", "lin_load", "drive"),
              P=[0, 100, 250], Q=[0, 50, 100], X_sh=[0.005, 0, 0],
              line_from=[0, 1], line_to=[1, 2], R=[0.5, 1.0], X=[2.0, 4.0],
              per_unit=False)
    entry = [{"kind": "six_pulse", "I1": 0.3, "alpha": np.deg2rad(20.0)}]
    jnet = hpfx.network_from_arrays(settings=s, **kw)
    jdev = hpfx.converter_device_set(jnet, s, entry)
    ts, net, dev = torch_side(s, jnet, jdev)
    jo = j_size(jnet, jdev, s, bus=2, orders=[5, 7], residual=0.05,
                V0=hpfx.converter_warm_start(jnet, s, jdev))
    to = taf.size_active_filter(net, dev, ts, bus=2, orders=[5, 7],
                                residual=0.05,
                                V0=ht.converter_warm_start(net, ts, dev))
    same_sizing(jo, to)
    assert to.misfit < 1e-8 and to.n_solves <= 14


def test_sizer_input_validation(net2_h9):
    P = net2_h9
    with pytest.raises(ValueError, match="out of range"):
        taf.size_active_filter(P.net, P.dev, P.ts, bus=99)
    with pytest.raises(ValueError, match="not compensatable"):
        taf.size_active_filter(P.net, P.dev, P.ts, bus=3, orders=[1])
    with pytest.raises(ValueError, match="not compensatable"):
        taf.size_active_filter(P.net, P.dev, P.ts, bus=3, orders=[4])
    with pytest.raises(ValueError, match="duplicate"):
        taf.size_active_filter(P.net, P.dev, P.ts, bus=[3, 3])
