"""Background (upstream) distortion in the port against the JAX package,
on the CPU in float64: the source constructors (hpfx_torch.background),
I_bg in the single case (hpf_single, dense and arrow solvers) and in the
batched study (background_sweep on the device and host schedules, and
hpf_sweep in both layouts), the float64 last resort of the rescue, and
the schedule rule.  Both packages start from the same arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import solve as jsolve
from hpfx_torch import solve as tsolve
from hpfx_torch.cx import Cx

from test_torch_foundations import one_torch_thread  # noqa: F401
from test_torch_sweep_api import (V_TOL, V_TOL_COLD_H25, close, pair,
                                  phasor, same, scenarios, to_np)

SPECTRUM = {5: (0.02, 0.3), 7: (0.01, 1.0)}


def _both(a):
    """A complex (..., H, n) numpy array as JAX's and the port's Cx."""
    return (hpfx.Cx(jnp.asarray(a.real), jnp.asarray(a.imag)),
            Cx(torch.tensor(a.real), torch.tensor(a.imag)))


def _batch(P, B, seed):
    """Per-scenario Thevenin backgrounds behind the slack's grid
    impedance: random magnitudes up to 2% and angles on every harmonic."""
    rng = np.random.default_rng(seed)
    H, n = P.s.n_harmonics, P.net.n
    x_sh = float(np.asarray(P.jnet.bus_Xsh)[0])
    orders = np.asarray(P.s.harmonics, float)
    i = (rng.uniform(0, 0.02, (B, H))
         * np.exp(1j * rng.uniform(0, 2 * np.pi, (B, H)))
         / (1j * x_sh * orders))
    i[:, 0] = 0.0
    full = np.zeros((B, H, n), complex)
    full[:, :, 0] = i
    return _both(full)


def test_sources_match_jax():
    """grid_source, current_source and background_from_harmonics (both
    forms) give the JAX package's tensors exactly."""
    P = pair("net2", 25)
    jb = hpfx.background_from_harmonics(P.jnet, P.s, SPECTRUM)
    tb = ht.background_from_harmonics(P.net, P.ts, SPECTRUM)
    jc = hpfx.background_from_harmonics(P.jnet, P.s, {5: (0.5, -0.2)},
                                        bus=2, as_current=True)
    tc = ht.background_from_harmonics(P.net, P.ts, {5: (0.5, -0.2)},
                                      bus=2, as_current=True)
    H = P.s.n_harmonics
    rng = np.random.default_rng(1)
    vm, va = rng.uniform(0, 0.05, H), rng.uniform(0, 6, H)
    vm[0] = 0.0
    jg = hpfx.grid_source(P.jnet, P.s, vm, va, bus=0)
    tg = ht.grid_source(P.net, P.ts, vm, va, bus=0)
    i_bg = rng.normal(size=H) + 1j * rng.normal(size=H)
    i_bg[0] = 0.0
    ji, ti = _both(i_bg)
    js = hpfx.current_source(P.s, P.jnet.n, ji, bus=1)
    ts_ = ht.current_source(P.ts, P.net.n, ti, bus=1)
    for j, t in ((jb, tb), (jc, tc), (jg, tg), (js, ts_)):
        assert tuple(t.shape) == (H, P.net.n)
        np.testing.assert_array_equal(to_np(t.re), np.asarray(j.re))
        np.testing.assert_array_equal(to_np(t.im), np.asarray(j.im))
    assert not to_np(tb.re[0]).any() and not to_np(tb.im[0]).any()


@pytest.mark.parametrize("case", ["fundamental", "order", "no_shunt"])
def test_sources_reject(case):
    """Order 1, orders outside the settings and a Thevenin source at a
    bus without grid impedance raise, as in the JAX package."""
    P = pair("net2", 25)
    H = P.s.n_harmonics
    with pytest.raises(ValueError):
        if case == "fundamental":
            ht.background_from_harmonics(P.net, P.ts, {1: (0.1, 0.0)})
        elif case == "order":
            ht.background_from_harmonics(P.net, P.ts, {27: (0.1, 0.0)})
        else:
            ht.grid_source(P.net, P.ts, np.zeros(H), np.zeros(H), bus=2)


@pytest.mark.parametrize("solver", ["dense", "arrow"])
def test_hpf_single_background_matches_jax(solver):
    """hpf_single with I_bg against the JAX package's; a zero background
    is the run without one, bit for bit; the background raises the THD
    of every bus."""
    P = pair("net2", 25, solver=solver)
    jb = hpfx.background_from_harmonics(P.jnet, P.s, SPECTRUM)
    tb = ht.background_from_harmonics(P.net, P.ts, SPECTRUM)
    rt = ht.hpf_single(P.net, P.dev, P.ts, I_bg=tb)
    same(jsolve.hpf_single(P.jnet, P.jdev, P.s, I_bg=jb), rt)
    plain = ht.hpf_single(P.net, P.dev, P.ts)
    zero = ht.hpf_single(P.net, P.dev, P.ts, I_bg=tb * 0.0)
    assert torch.equal(zero.V_m, plain.V_m)
    assert int(zero.n_iter) == int(plain.n_iter)
    thd = lambda r: ht.get_thd(r.V_m).THD_F
    assert bool((thd(rt) > thd(plain)).all())


@pytest.mark.parametrize("layout", ["lanes", "vmap"])
def test_background_sweep_layouts_match_jax(layout):
    """hpf_sweep with a per-scenario (B, H, n) I_bg: the lane-major
    layout against the JAX package's, the batch-major one against the
    lane-major one."""
    P = pair("net2", 25, solver="arrow", stable_mismatch=True,
             layout="lanes")
    B = 4
    jb, tb = _batch(P, B, 11)
    js, tsc = scenarios(np.linspace(0.9, 1.1, B), None,
                        np.linspace(0.8, 1.2, B))
    rt = ht.hpf_sweep(P.net, P.dev, P.ts, tsc, I_bg=tb)
    if layout == "lanes":
        same(jsolve.hpf_sweep(P.jnet, P.jdev, P.s, js, I_bg=jb), rt)
    else:
        same(rt, ht.hpf_sweep(P.net, P.dev, P.ts.with_(layout="vmap"), tsc,
                              I_bg=tb))


@pytest.mark.parametrize("schedule,warm,tol", [
    ("device", "linear", V_TOL), ("host", "cold", V_TOL_COLD_H25)])
def test_background_sweep_matches_jax(schedule, warm, tol):
    """background_sweep on the device schedule from the seed (the
    background in the lane layout and in the seed's right-hand side: 3
    trips) and on the host schedule from the cold start (up to 16 trips,
    so V_TOL_COLD_H25), against the JAX package's."""
    P = pair("net2", 25, solver="arrow", stable_mismatch=True,
             layout="lanes")
    B = 4
    jb, tb = _batch(P, B, 7)
    rj = hpfx.background_sweep(P.jnet, P.jdev, P.s, jb, schedule=schedule,
                               warm=warm)
    rt = ht.background_sweep(P.net, P.dev, P.ts, tb, schedule=schedule,
                             warm=warm)
    same(rj, rt, tol)


def test_background_host_schedule_takes_warm():
    """The port forwards warm= to the host schedule (the JAX package
    drops it): warm="linear" with a batched I_bg raises there, where the
    JAX package would start cold unasked."""
    P = pair("net2", 5, solver="arrow", layout="lanes")
    _, tb = _batch(P, 2, 3)
    with pytest.raises(ValueError, match="batched I_bg"):
        ht.background_sweep(P.net, P.dev, P.ts, tb, schedule="host",
                            warm="linear")


@pytest.mark.parametrize("layout,route", [("lanes", "device"),
                                          ("auto", "device"),
                                          ("vmap", "host")])
def test_background_auto_schedule(monkeypatch, layout, route):
    """schedule="auto" takes the device schedule where the lane-major
    path applies, on either device, the host schedule otherwise."""
    taken = []
    monkeypatch.setattr(tsolve, "hpf_sweep_device",
                        lambda *a, **k: taken.append("device"))
    monkeypatch.setattr(tsolve, "hpf_sweep_adaptive",
                        lambda *a, **k: taken.append("host"))
    P = pair("net2", 5, solver="arrow", layout=layout)
    _, tb = _batch(P, 2, 3)
    ht.background_sweep(P.net, P.dev, P.ts, tb)
    assert taken == [route]


def test_background_f64_last_resort():
    """A float32 threshold below float32's evaluation floor defeats both
    float32 rescue passes; the float64 re-solve, which takes the
    stragglers' I_bg rows, converges every scenario
    (tests/test_background.py::test_background_sweep_f64_knife_edge_rescue)."""
    P = pair("net2", 25, solver="arrow", stable_mismatch=True,
             floor_kappa=0.0, thresh_h=3e-8)
    ts = P.ts.with_(dtype="float32")
    net, dev = P.net.to(dtype=torch.float32), P.dev.to(dtype=torch.float32)
    B, H, n = 4, P.s.n_harmonics, P.net.n
    full = np.zeros((B, H, n), complex)
    full[:, 2, 0] = 0.01 / (1j * float(np.asarray(P.jnet.bus_Xsh)[0]) * 5)
    tb = Cx(torch.tensor(full.real, dtype=torch.float32),
            torch.tensor(full.imag, dtype=torch.float32))
    r = ht.background_sweep(net, dev, ts, tb)
    assert bool(r.converged.all())
    assert r.V_m.dtype == torch.float32
    assert float(r.err.max()) < 3e-8
    r64 = ht.background_sweep(P.net, P.dev, P.ts,
                              Cx(tb.re.double(), tb.im.double()))
    assert np.abs(phasor(r) - phasor(r64)).max() < 1e-4
    close(r.V_m.double(), r64.V_m, 1e-4)
