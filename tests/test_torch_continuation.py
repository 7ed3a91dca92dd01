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
