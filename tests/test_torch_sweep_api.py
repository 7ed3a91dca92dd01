"""The rest of the sweep API of the port against the JAX package, on the
CPU in float64: the admittance hooks (Rh/Ys/Ysh), device libraries and
Scenarios.device_mix in both layouts and through the adaptive schedule,
analytic devices (AnalyticDeviceSet with torch.func), the Y override,
the exact-linear seed on the host schedule (norton_warm_start,
hpf_sweep_adaptive(warm="linear")), V0 and bucketed rescue widths on the
lane-major adaptive sweep, the stream executor and the THD aggregates.
Both packages start from the same arrays (hpfx_torch.convert).

Tolerances: float64 on net2/net3/net4 within V_TOL pu with identical
iteration counts and converged flags; net1 within
tests/test_torch_net1.py's bounds (its chaotic float64 transient)."""
import dataclasses
import functools
import os
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import lanes as jl
from hpfx import solve as jsolve
from hpfx.devices import AnalyticDeviceSet as JAnalytic
from hpfx.devices import norton_inject as j_norton_inject
from hpfx.warmstart import norton_warm_start as j_warm_start
from hpfx.ybus import line_ybus_pair as j_line_pair
from hpfx_torch import lanes as tl
from hpfx_torch.cx import Cx
from hpfx_torch.ybus import line_ybus_pair

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_net1 import VM_TOL_F64 as NET1_VM_TOL

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
#: float64 port against float64 JAX on net2/net3/net4
V_TOL = 1e-10
#: the same from the cold start at net2 H<=25: 10-20 Newton trips with
#: residuals ~1e2 amplify the two packages' rounding (their LU, and the
#: order of the device sums) to 4e-10-2.4e-9 pu, counts identical.  Held
#: to the repository's voltage parity gate, 1e-8 (tests/test_harmonic.py)
V_TOL_COLD_H25 = 1e-8
LIBRARY = ("SMPS", "ev_1", "ev_4")


class Pair(NamedTuple):
    """Both packages' float64 settings, network and devices, the port's
    built from the JAX package's arrays."""
    s: object
    jnet: object
    jdev: object
    ts: ht.Settings
    net: ht.Network
    dev: ht.DeviceSet


def pair(name, h_max, coupled=True, **kw) -> Pair:
    s = hpfx.settings_for_hmax(h_max, coupled=coupled, **kw)
    jnet = hpfx.load_network(os.path.join(DATA, f"{name}_buses.csv"),
                             os.path.join(DATA, f"{name}_lines.csv"), s)
    jdev = hpfx.load_device_set(jnet, s)
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    ts = ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64")
    return Pair(s, jnet, jdev, ts, net, dev)


def scenarios(*arrays):
    """The same scales as a JAX and a port Scenarios."""
    return (jsolve.Scenarios(*(None if a is None else jnp.asarray(a)
                               for a in arrays)),
            ht.Scenarios(*(None if a is None else torch.tensor(a)
                           for a in arrays)))


def spread(B, n_nl=None, seed=3, mix_types=None):
    """Seeded scales: per-scenario p and q, per-device injections when
    ``n_nl`` is given, and (B, n_nl, T) mixes when ``mix_types`` is."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.85, 1.15, B)
    q = rng.uniform(0.85, 1.15, B)
    inj = rng.uniform(0.6, 1.4, B if n_nl is None else (B, n_nl))
    mix = None if mix_types is None else rng.uniform(
        0.0, 1.0, (B, n_nl, mix_types))
    return p, q, inj, mix


def to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=V_TOL):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def phasor(r):
    return to_np(r.V_m) * np.exp(1j * to_np(r.V_a))


def same(rj, rt, tol=V_TOL):
    """Identical counts and flags, every scenario converged, magnitudes
    and phasors within ``tol``."""
    np.testing.assert_array_equal(to_np(rt.n_iter), to_np(rj.n_iter))
    np.testing.assert_array_equal(to_np(rt.converged), to_np(rj.converged))
    assert to_np(rt.converged).all()
    close(rt.V_m, rj.V_m, tol)
    close(phasor(rt), phasor(rj), tol)


def j_cx(a):
    return hpfx.Cx(jnp.asarray(a.real), jnp.asarray(a.imag))


def t_cx(a):
    return Cx(torch.tensor(a.real), torch.tensor(a.imag))


# ---------------------------------------------------------------------------
# admittance hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compat", [False, True], ids=["plain", "compat"])
@pytest.mark.parametrize("name", ["net2", "net3"])
def test_build_ybus_hooks_match_jax(name, compat):
    """build_ybus, build_line_ybus and line_ybus_pair with a per-harmonic
    resistance Rh, and with Ys/Ysh replaced outright, against the JAX
    package's to 1e-14 of the admittances' scale."""
    P = pair(name, 25, stable_mismatch=True, compat_shunt_bug=compat)
    H, L = P.s.n_harmonics, P.net.line_R.shape[0]
    rng = np.random.default_rng(8)
    Rh = np.asarray(P.jnet.line_R) * rng.uniform(1.0, 3.0, (H, L))
    Ys = rng.normal(size=(H, L)) + 1j * rng.normal(size=(H, L))
    Ysh = 1e-3 * (rng.normal(size=(H, L)) + 1j * rng.normal(size=(H, L)))
    for jkw, tkw in ((dict(Rh=jnp.asarray(Rh)), dict(Rh=torch.tensor(Rh))),
                     (dict(Ys=j_cx(Ys), Ysh=j_cx(Ysh)),
                      dict(Ys=t_cx(Ys), Ysh=t_cx(Ysh)))):
        Yj = hpfx.build_ybus(P.jnet, P.s, **jkw)
        Yt = ht.build_ybus(P.net, P.ts, **tkw)
        tol = 1e-14 * np.abs(np.asarray(Yj.re)).max()
        close(Yt.re, Yj.re, tol)
        close(Yt.im, Yj.im, tol)
        for lj, lt in zip(j_line_pair(P.jnet, P.s, **jkw),
                          line_ybus_pair(P.net, P.ts, **tkw)):
            for part in ("Ys", "d"):
                for c in ("re", "im"):
                    close(getattr(getattr(lt, part), c),
                          getattr(getattr(lj, part), c), tol)


# ---------------------------------------------------------------------------
# device libraries and device mixes
# ---------------------------------------------------------------------------

def library_pair(P: Pair):
    jlib = hpfx.load_device_library(LIBRARY, P.s)
    return jlib, ht.load_device_library(LIBRARY, P.ts, device="cpu")


@pytest.mark.parametrize("coupled", [True, False], ids=["c", "uc"])
def test_device_library_matches_jax(coupled):
    """load_device_library reads the same tables exactly; mixed() blends
    with leading scenario axes as JAX's vmapped mixed() does;
    library_from_hpfx_arrays and device_set_from_arrays carry JAX's arrays
    across."""
    P = pair("net4", 9, coupled)
    jlib, tlib = library_pair(P)
    assert tlib.n_types == 3 and tlib.index("ev_1") == jlib.index("ev_1")
    for part in ("I_lib", "Y_lib"):
        for c in ("re", "im"):
            np.testing.assert_array_equal(
                to_np(getattr(getattr(tlib, part), c)),
                np.asarray(getattr(getattr(jlib, part), c)))
    w = spread(4, P.net.n - P.net.m, mix_types=3)[3]
    jm = jax.vmap(jlib.mixed)(jnp.asarray(w))
    tm = tlib.mixed(torch.tensor(w))
    for part in ("I_N", "Y_N"):
        for c in ("re", "im"):
            want = getattr(getattr(jm, part), c)
            close(getattr(getattr(tm, part), c), want,
                  1e-14 * np.abs(np.asarray(want)).max())
    leaves = dict(I_lib=(np.asarray(jlib.I_lib.re), np.asarray(jlib.I_lib.im)),
                  Y_lib=(np.asarray(jlib.Y_lib.re), np.asarray(jlib.Y_lib.im)),
                  coupled=jlib.coupled, names=jlib.names)
    back = ht.library_from_hpfx_arrays(leaves, device="cpu")
    assert back.names == LIBRARY and back.coupled == coupled
    assert torch.equal(back.Y_lib.re, tlib.Y_lib.re)
    I1 = jlib.I_lib.to_numpy()[1]
    Y1 = jlib.Y_lib.to_numpy()[1]
    jd = hpfx.devices.device_set_from_arrays(I1, Y1, coupled, P.s)
    td = ht.device_set_from_arrays(I1, Y1, coupled, P.ts, device="cpu")
    assert td.n_devices == jd.n_devices == 1
    np.testing.assert_array_equal(to_np(td.Y_N.im), np.asarray(jd.Y_N.im))


@pytest.mark.parametrize("layout", ["lanes", "vmap"])
@pytest.mark.parametrize("kind", ["one_hot", "blend"])
def test_device_mix_matches_jax(kind, layout):
    """A DeviceLibrary with Scenarios.device_mix in both layouts against
    the JAX package's (tests/test_scenario_axes.py's cases): a one-hot
    mix that reproduces net4's own type assignment also equals the
    DeviceSet sweep, and a blended mix with per-device scales."""
    P = pair("net4", 9, solver="arrow", layout=layout)
    jlib, tlib = library_pair(P)
    n_nl, B = P.net.n - P.net.m, 4
    p, q, inj, w = spread(B, n_nl, seed=11, mix_types=3)
    if kind == "one_hot":
        w = np.zeros((B, n_nl, 3))
        for d, name in enumerate(("SMPS", "ev_1", "ev_4")):
            w[:, d, jlib.index(name)] = 1.0
    js, tsc = scenarios(p, q, inj, w)
    rj = jsolve.hpf_sweep(P.jnet, jlib, P.s, js)
    rt = ht.hpf_sweep(P.net, tlib, P.ts, tsc)
    same(rj, rt)
    if kind == "one_hot":
        plain = ht.hpf_sweep(P.net, P.dev, P.ts, tsc._replace(device_mix=None))
        np.testing.assert_array_equal(to_np(plain.n_iter), to_np(rt.n_iter))
        close(rt.V_m, plain.V_m, 1e-12)


def test_one_hot_mix_is_the_device_set_sweep_f32():
    """In float32, where a chaotic transient turns any difference of
    rounding into a different end state, a one-hot mix of net1's own
    device type runs the DeviceSet sweep's arithmetic: the host schedule
    gives the same tensors, bit for bit (chip_smoke.py phase 16b holds
    the same on the card)."""
    P = pair("net1", 25, solver="arrow", stable_mismatch=True,
             big_solve="panel", layout="lanes")
    ts = P.ts.with_(dtype="float32")
    f32 = torch.float32
    net, dev = P.net.to(dtype=f32), P.dev.to(dtype=f32)
    lib = ht.load_device_library(("SMPS", "ev_1"), ts, device="cpu")
    B, n_nl = 16, P.net.n - P.net.m
    sc = ht.Scenarios(*(torch.tensor(a, dtype=f32) for a in spread(B)[:3]))
    w = torch.zeros((B, n_nl, 2), dtype=f32)
    w[:, :, lib.index("SMPS")] = 1.0
    plain = ht.hpf_sweep_adaptive(net, dev, ts, sc, phase_iters=8)
    mixed = ht.hpf_sweep_adaptive(net, lib, ts, sc._replace(device_mix=w),
                                  phase_iters=8)
    assert (to_np(plain.n_iter) > 8).any()
    for k in ("V_m", "V_a", "err", "n_iter", "converged"):
        assert torch.equal(getattr(mixed, k), getattr(plain, k)), k


def test_device_mix_adaptive_matches_jax():
    """hpf_sweep_adaptive's phase 2 and rescue take every scenario leaf,
    (B, n_nl) scales and (B, n_nl, T) mixes included
    (tests/test_scenario_axes.py::test_adaptive_sweep_with_device_axes,
    there at H<=25).  At H<=9: with these draws at H<=25 the float64
    transient is chaotic (residuals ~1e2 for a dozen trips; the two
    packages' first residuals differ at 1e-12 relative and the gap grows
    ~10x a trip, so one scenario stops a trip later in one package, the
    net1 behaviour of tests/test_torch_net1.py, which the JAX package's
    own lanes and vmap layouts share)."""
    P = pair("net4", 9, solver="arrow", layout="lanes")
    jlib, tlib = library_pair(P)
    p, q, inj, w = spread(6, P.net.n - P.net.m, seed=5, mix_types=3)
    js, tsc = scenarios(p, q, inj, w)
    rj = jsolve.hpf_sweep_adaptive(P.jnet, jlib, P.s, js, phase_iters=6)
    log = ht.PhaseLog()
    rt = ht.hpf_sweep_adaptive(P.net, tlib, P.ts, tsc, phase_iters=6,
                               log=log)
    assert log.trips["phase2"] > 0
    same(rj, rt)


def test_mix_and_device_types_are_checked():
    """A device_mix needs a DeviceLibrary and a DeviceLibrary needs a
    device_mix (ValueError); a devices of any other type raises
    TypeError, in the single case and the sweeps."""
    P = pair("net4", 9)
    _, tlib = library_pair(P)
    one = torch.ones(2, dtype=torch.float64)
    mix = torch.ones((2, P.net.n - P.net.m, 3), dtype=torch.float64) / 3
    with pytest.raises(ValueError, match="DeviceLibrary"):
        ht.hpf_sweep(P.net, P.dev, P.ts, ht.Scenarios(one, device_mix=mix))
    with pytest.raises(ValueError, match="device_mix"):
        ht.hpf_sweep(P.net, tlib, P.ts, ht.Scenarios(one))
    for call in (lambda d: ht.hpf(P.net, d, P.ts),
                 lambda d: ht.hpf_single(P.net, d, P.ts),
                 lambda d: ht.hpf_sweep(P.net, d, P.ts, ht.Scenarios(one))):
        with pytest.raises(TypeError, match="devices must be one of"):
            call(object())
    with pytest.raises(TypeError, match="device_mix"):
        ht.hpf(P.net, tlib, P.ts)


# ---------------------------------------------------------------------------
# analytic devices
# ---------------------------------------------------------------------------

def analytic_pair(P: Pair):
    ja = JAnalytic(params=(P.jdev.I_N, P.jdev.Y_N), inject=j_norton_inject,
                   n_nl=P.jnet.n_nonlinear)
    ta = ht.AnalyticDeviceSet(params=(P.dev.I_N, P.dev.Y_N),
                              inject=ht.norton_inject,
                              n_nl=P.net.n - P.net.m)
    return ja, ta


def test_injection_jacobians_match_jacfwd():
    """AnalyticDeviceSet.injections and injection_jacobians (torch.func
    vmap and jacfwd) against jax.vmap/jax.jacfwd to 1e-12, per device and
    with a leading scenario axis and per-device scales; for norton_inject
    they are the closed-form Norton coupling."""
    P = pair("net4", 9)
    ja, ta = analytic_pair(P)
    H, n_nl = P.s.n_harmonics, P.net.n - P.net.m
    rng = np.random.default_rng(2)
    Vm = rng.uniform(0.05, 1.0, (3, H, n_nl))
    Va = rng.uniform(0.0, 2 * np.pi, (3, H, n_nl))
    scale = rng.uniform(0.5, 1.5, (3, n_nl))
    tb = ta.scale(torch.tensor(scale))
    Ib = tb.injections(torch.tensor(Vm), torch.tensor(Va))
    JVb, JAb = tb.injection_jacobians(torch.tensor(Vm), torch.tensor(Va))
    def one(sc, vm, va):
        jk = ja.scale(sc)
        return jk.injections(vm, va), *jk.injection_jacobians(vm, va)

    for got, want in zip((Ib, JVb, JAb), jax.jit(jax.vmap(one))(
            jnp.asarray(scale), jnp.asarray(Vm), jnp.asarray(Va))):
        close(got.re, want.re, 1e-12)
        close(got.im, want.im, 1e-12)
    KV, KA = ht.harmonic.norton_coupling(
        torch.tensor(np.pad(Vm[0], ((0, 0), (P.net.m, 0)))),
        torch.tensor(np.pad(Va[0], ((0, 0), (P.net.m, 0)))), ta, P.net.m)
    KVn, KAn = ht.harmonic.norton_coupling(
        torch.tensor(np.pad(Vm[0], ((0, 0), (P.net.m, 0)))),
        torch.tensor(np.pad(Va[0], ((0, 0), (P.net.m, 0)))), P.dev, P.net.m)
    close(KV.re, KVn.re, 1e-12)
    close(KA.im, KAn.im, 1e-12)


@pytest.mark.parametrize("solver", ["dense", "arrow"])
def test_analytic_hpf_matches_device_set_and_jax(solver):
    """hpf with AnalyticDeviceSet(norton_inject): the dense Jacobian's and
    the arrow step's coupling blocks by autodiff, against the DeviceSet
    solve (held to the JAX package's in tests/test_torch_single.py; the
    analytic sweeps below are held to the JAX package's analytic ones)."""
    P = pair("net2", 5, solver=solver)
    rt = ht.hpf(P.net, analytic_pair(P)[1], P.ts)
    same(ht.hpf(P.net, P.dev, P.ts), rt)


@pytest.mark.parametrize("layout", ["lanes", "vmap"])
def test_analytic_sweep_matches_jax(layout):
    """An AnalyticDeviceSet through hpf_sweep in both layouts, per-device
    scales, against the DeviceSet sweep, and on the lane-major layout
    (injections and coupling blocks vectorized over the lanes) against
    the JAX package's."""
    P = pair("net4", 5, solver="arrow", layout=layout)
    ja, ta = analytic_pair(P)
    p, q, inj, _ = spread(4, P.net.n - P.net.m, seed=7)
    js, tsc = scenarios(p, q, inj)
    rt = ht.hpf_sweep(P.net, ta, P.ts, tsc)
    same(ht.hpf_sweep(P.net, P.dev, P.ts, tsc), rt)
    if layout == "lanes":
        same(jsolve.hpf_sweep(P.jnet, ja, P.s, js), rt)


# ---------------------------------------------------------------------------
# the Y override
# ---------------------------------------------------------------------------

def test_sweep_y_override_matches_jax():
    """hpf_sweep with a dense Y override (admittances built with a
    per-harmonic resistance; the stable mismatch then off): the
    lane-major layout against the JAX package's, the batch-major one
    against the lane-major one."""
    P = pair("net2", 5, solver="arrow", stable_mismatch=True,
             layout="lanes")
    H, L = P.s.n_harmonics, P.net.line_R.shape[0]
    Rh = np.asarray(P.jnet.line_R) * np.linspace(1.0, 2.0, H)[:, None] \
        * np.ones((1, L))
    Yj = hpfx.build_ybus(P.jnet, P.s, jnp.asarray(Rh))
    Yt = ht.build_ybus(P.net, P.ts, torch.tensor(Rh))
    js, tsc = scenarios(*spread(4)[:3])
    rt = ht.hpf_sweep(P.net, P.dev, P.ts, tsc, Y=Yt)
    same(jsolve.hpf_sweep(P.jnet, P.jdev, P.s, js, Y=Yj), rt)
    same(rt, ht.hpf_sweep(P.net, P.dev, P.ts.with_(layout="vmap"), tsc,
                          Y=Yt))
    base = ht.hpf_sweep(P.net, P.dev, P.ts, tsc)
    assert np.abs(to_np(base.V_m) - to_np(rt.V_m)).max() > 1e-6


# ---------------------------------------------------------------------------
# the exact-linear seed on the host schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [("net3", 25, True), ("net2", 5, False)],
                         ids=["net3_h25_c", "net2_h5_uc"])
def test_norton_warm_start_matches_jax(cfg, monkeypatch):
    """The batched seed against the JAX package's, and chunked over the
    scenarios (3 a chunk, the last short) equal to one chunk."""
    P = pair(*cfg)
    js, tsc = scenarios(*spread(5, P.net.n - P.net.m)[:3])
    Vj = j_warm_start(P.jnet, P.jdev, P.s, js)
    Vt = ht.norton_warm_start(P.net, P.dev, P.ts, tsc)
    close(Vt[0], Vj[0])
    close(Vt[0] * torch.exp(1j * Vt[1]),
          np.asarray(Vj[0]) * np.exp(1j * np.asarray(Vj[1])))
    Kn = (P.s.n_harmonics - 1) * P.net.n
    monkeypatch.setattr(tl, "SEED_CHUNK_BYTES", 3 * 8 * Kn * Kn * 8)
    chunked = ht.norton_warm_start(P.net, P.dev, P.ts, tsc)
    assert torch.equal(chunked[0], Vt[0]) and torch.equal(chunked[1], Vt[1])
    with pytest.raises(TypeError, match="DeviceSet"):
        ht.norton_warm_start(P.net, analytic_pair(P)[1], P.ts, tsc)


def test_adaptive_warm_linear_matches_jax():
    """hpf_sweep_adaptive(warm="linear") against the JAX package's on the
    lane-major layout: the seed, then phase 1 capped at 2 trips so that
    phase 2 runs; identical counts, and a seed phase in the log."""
    P = pair("net3", 25, solver="arrow", stable_mismatch=True,
             layout="lanes")
    js, tsc = scenarios(*spread(6)[:3])
    rj = jsolve.hpf_sweep_adaptive(P.jnet, P.jdev, P.s, js, phase_iters=2,
                                   warm="linear")
    log = ht.PhaseLog()
    rt = ht.hpf_sweep_adaptive(P.net, P.dev, P.ts, tsc, phase_iters=2,
                               warm="linear", log=log)
    assert "seed" in log.seconds and log.trips["phase2"] > 0
    same(rj, rt)
    cold = ht.hpf_sweep_adaptive(P.net, P.dev, P.ts, tsc, phase_iters=2)
    assert to_np(rt.n_iter).sum() < to_np(cold.n_iter).sum()


def test_adaptive_warm_linear_net1_matches_jax():
    """The same at net1 H<=25 (the host schedule's own network), held to
    tests/test_torch_net1.py's float64 bounds: identical converged flags,
    |dV_m| <= its VM_TOL_F64."""
    P = pair("net1", 25, solver="arrow", stable_mismatch=True,
             big_solve="panel", layout="lanes")
    B = 4
    js, tsc = scenarios(np.linspace(0.8, 1.2, B), np.linspace(0.8, 1.2, B),
                        np.linspace(0.6, 1.4, B))
    rj = jsolve.hpf_sweep_adaptive(P.jnet, P.jdev, P.s, js, phase_iters=24,
                                   warm="linear")
    rt = ht.hpf_sweep_adaptive(P.net, P.dev, P.ts, tsc, phase_iters=24,
                               warm="linear")
    np.testing.assert_array_equal(to_np(rt.converged), to_np(rj.converged))
    assert to_np(rt.converged).all()
    close(rt.V_m, rj.V_m, NET1_VM_TOL)


def test_warm_linear_with_batched_background_raises():
    P = pair("net2", 5, solver="arrow", layout="lanes")
    B, H, n = 2, P.s.n_harmonics, P.net.n
    z = torch.zeros((B, H, n), dtype=torch.float64)
    with pytest.raises(ValueError, match="batched I_bg"):
        ht.hpf_sweep_adaptive(P.net, P.dev, P.ts,
                              ht.Scenarios.uniform(B, torch.float64, "cpu"),
                              warm="linear", I_bg=Cx(z, z))


# ---------------------------------------------------------------------------
# the lane-major adaptive sweep: V0 and bucketed rescue widths
# ---------------------------------------------------------------------------

def test_adaptive_lanes_v0():
    """hpf_sweep_adaptive_lanes(V0=...) (tests/test_warmstart.py::
    test_explicit_v0_threads_through_device_sweep): from the batched
    seed, its fundamental row replaced by the sweep's own, it is the run
    from the in-program seed (warm="linear", the same exact-linear
    solution at the same fundamental): identical counts and voltages
    within V_TOL; both take no more trips than the cold start."""
    P = pair("net3", 25, solver="arrow", stable_mismatch=True,
             layout="lanes")
    tsc = scenarios(*spread(6)[:3])[1]
    V0 = ht.norton_warm_start(P.net, P.dev, P.ts, tsc)
    V0[0][:, 0] = 7.0                     # replaced by the fundamental
    rt = ht.hpf_sweep_adaptive_lanes(P.net, P.dev, P.ts, tsc, V0=V0)
    same(ht.hpf_sweep_adaptive_lanes(P.net, P.dev, P.ts, tsc,
                                     warm="linear"), rt)
    cold = ht.hpf_sweep_adaptive_lanes(P.net, P.dev, P.ts, tsc)
    assert to_np(rt.n_iter).max() <= to_np(cold.n_iter).max()


def test_bucketed_rescue_widths():
    """rescue_width as a tuple (tests/test_lanes.py::
    test_adaptive_lanes_bucketed_rescue_widths): phase_iters=1 leaves
    nearly every lane unconverged, a width-2 rescue leaves some
    unconverged, the bucketed (2, B) escalates to B and converges all,
    equal bit for bit to the single width B, and to the JAX package's
    bucketed program within V_TOL."""
    P = pair("net2", 25, solver="arrow", layout="lanes")
    B = 16
    js, tsc = scenarios(np.linspace(0.85, 1.15, B),
                        np.linspace(0.85, 1.15, B), np.linspace(0.7, 1.3, B))
    run = lambda w: ht.hpf_sweep_adaptive_lanes(
        P.net, P.dev, P.ts, tsc, phase_iters=1, rescue_width=w)
    assert not bool(run(2).converged.all())
    bucketed = run((2, B))
    assert bool(bucketed.converged.all())
    wide = run(B)
    assert torch.equal(bucketed.V_m, wide.V_m)
    assert torch.equal(bucketed.n_iter, wide.n_iter)
    rj = jax.jit(functools.partial(
        jl.hpf_sweep_adaptive_lanes, settings=P.s, phase_iters=1,
        rescue_width=(2, B)))(P.jnet, P.jdev, scenarios=js)
    same(rj, bucketed, V_TOL_COLD_H25)


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

def _stream_batch(k, B=8):
    return scenarios(np.linspace(0.85, 1.15, B) + 1e-3 * k,
                     np.linspace(0.85, 1.15, B), np.linspace(0.7, 1.3, B))


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_equals_device_sweep(depth):
    """hpf_sweep_stream yields one result per batch, in input order, equal
    bit for bit to hpf_sweep_device on that batch (tests/test_lanes.py's
    stream case)."""
    P = pair("net2", 5, True, solver="arrow", stable_mismatch=True,
             layout="lanes")
    ref = [ht.hpf_sweep_device(P.net, P.dev, P.ts, _stream_batch(k)[1],
                               phase_iters=16) for k in range(3)]
    got = list(ht.hpf_sweep_stream(P.net, P.dev, P.ts,
                                   (_stream_batch(k)[1] for k in range(3)),
                                   phase_iters=16, depth=depth))
    assert len(got) == 3
    for r_ref, r_got in zip(ref, got):
        assert bool(r_got.converged.all())
        assert torch.equal(r_got.V_m, r_ref.V_m)
        assert torch.equal(r_got.V_a, r_ref.V_a)
        assert torch.equal(r_got.n_iter, r_ref.n_iter)


def test_stream_host_rescue_and_jax():
    """A narrow program (phase_iters=2, rescue width 1) leaves stragglers
    that the stream's host rescue converges at dequeue, as
    hpf_sweep_device does with the same program; a warm= beside a
    program warns.  One batch against the JAX package's stream."""
    P = pair("net2", 5, True, solver="arrow", stable_mismatch=True,
             layout="lanes")
    narrow = functools.partial(ht.hpf_sweep_adaptive_lanes, settings=P.ts,
                               phase_iters=2, rescue_width=1)
    assert not bool(narrow(P.net, P.dev,
                           scenarios=_stream_batch(0)[1]).converged.all())
    got = list(ht.hpf_sweep_stream(P.net, P.dev, P.ts,
                                   [_stream_batch(k)[1] for k in range(2)],
                                   depth=2, program=narrow))
    for k, r in enumerate(got):
        assert bool(r.converged.all())
        r_ref = ht.hpf_sweep_device(P.net, P.dev, P.ts, _stream_batch(k)[1],
                                    program=narrow)
        assert torch.equal(r.V_m, r_ref.V_m)
    with pytest.warns(UserWarning, match="program"):
        ht.hpf_sweep_device(P.net, P.dev, P.ts, _stream_batch(0)[1],
                            program=narrow, warm="linear")
    js, tsc = _stream_batch(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = next(jsolve.hpf_sweep_stream(P.jnet, P.jdev, P.s, [js],
                                          phase_iters=16, warm="linear"))
    rt = next(ht.hpf_sweep_stream(P.net, P.dev, P.ts, [tsc], phase_iters=16,
                                  warm="linear"))
    same(rj, rt)


# ---------------------------------------------------------------------------
# the THD aggregates
# ---------------------------------------------------------------------------

def test_hosting_capacity_and_summary():
    """summarize_thd and hosting_capacity_sweep (the JAX package's
    aggregate, vmapped get_thd) against the THD of every scenario's
    result computed apart with numpy."""
    P = pair("net2", 5, solver="arrow", layout="vmap")
    tsc = scenarios(*spread(6)[:3])[1]
    r = ht.hpf_sweep(P.net, P.dev, P.ts, tsc)
    Vm = to_np(r.V_m)
    thd = np.sqrt((Vm[:, 1:] ** 2).sum(axis=1)) / Vm[:, 0]
    worst = thd.max(axis=1)
    # a limit inside the spread, so that some scenarios exceed it
    limit = float(np.median(worst))
    st = ht.summarize_thd(r, thd_limit=limit)
    close(st.max_thd_f, worst, 1e-15)
    over = (worst > limit) & to_np(r.converged)
    assert 0 < over.sum() < 6
    close(st.frac_over_limit, over.mean(), 1e-15)
    hc = ht.hosting_capacity_sweep(P.net, P.dev, P.ts, tsc, thd_limit=limit,
                                   valid_count=5)
    close(hc.max_thd_f, worst, 1e-15)
    close(hc.frac_over_limit, over[:5].mean(), 1e-15)
