"""The port's main path against the JAX package's, end to end on the CPU:
hpfx_torch.solve.hpf_sweep_device against hpfx.solve.hpf_sweep_device at
the headline settings (net2 H<=25, arrow solver, stable mismatch, floor-
aware test, warm="linear", phase_iters=24), the JAX side on the lane-major
layout.  float64 must agree to 1e-9 with identical iteration counts; the
port's float32 path is held against float64 at the bounds chip_smoke.py
applies on the card."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx.solve import Scenarios as JScen
from hpfx.solve import hpf_sweep_device as j_sweep_device

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
V_TOL_F64 = 1e-9
#: f32 against f64: JAX f32 vs f64 on the CPU at this configuration
#: differed by 6.4e-6 in V_m and 6.5e-5 rad in V_a on harmonics of
#: magnitude <= 0.37; the bounds keep ~8x and ~4x headroom over that
VM_TOL_F32 = 5e-5
PHASOR_TOL_F32 = 1e-4


def _settings():
    s = hpfx.settings_for_hmax(25, coupled=True).with_(
        solver="arrow", stable_mismatch=True, big_solve="panel",
        layout="lanes")
    return s, ht.Settings(**dataclasses.asdict(s))


def _inputs(Bt):
    s, ts = _settings()
    jnet = hpfx.load_network(os.path.join(DATA, "net2_buses.csv"),
                             os.path.join(DATA, "net2_lines.csv"), s)
    jdev = hpfx.load_device_set(jnet, s)
    p = np.linspace(0.8, 1.2, Bt)
    inj = np.linspace(0.6, 1.4, Bt)
    return s, ts, jnet, jdev, p, inj


def _run_jax(Bt, **kw):
    s, _, jnet, jdev, p, inj = _inputs(Bt)
    sc = JScen(jnp.asarray(p), jnp.asarray(p), jnp.asarray(inj))
    r = j_sweep_device(jnet, jdev, s, sc, warm="linear", **kw)
    return {k: np.asarray(getattr(r, k))
            for k in ("V_m", "V_a", "n_iter", "converged", "err")}


def _run_torch(Bt, dtype, log=None, **kw):
    _, ts, jnet, jdev, p, inj = _inputs(Bt)
    ts = ts.with_(dtype=dtype)
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    net, dev = net.to(dtype=ts.real_dtype), dev.to(dtype=ts.real_dtype)
    t = lambda a: torch.tensor(a, dtype=ts.real_dtype)
    return ht.hpf_sweep_device(net, dev, ts, ht.Scenarios(t(p), t(p), t(inj)),
                               warm="linear", log=log, **kw)


def _angle_diff(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


@pytest.fixture(scope="module")
def jax_b32():
    return _run_jax(32, phase_iters=24)


@pytest.fixture(scope="module")
def jax_overflow():
    return _run_jax(32, phase_iters=1, rescue_width=4)


@pytest.fixture(scope="module")
def jax_b64():
    return _run_jax(64, phase_iters=24)


def _assert_f64_parity(j, r):
    Vm, Va = r.V_m.numpy(), r.V_a.numpy()
    assert Vm.shape == j["V_m"].shape
    np.testing.assert_allclose(Vm, j["V_m"], rtol=0, atol=V_TOL_F64)
    assert _angle_diff(Va, j["V_a"]).max() <= V_TOL_F64
    np.testing.assert_array_equal(r.n_iter.numpy(), j["n_iter"])
    np.testing.assert_array_equal(r.converged.numpy(), j["converged"])


def test_sweep_device_f64_matches_jax(jax_b32):
    log = ht.PhaseLog()
    r = _run_torch(32, "float64", log=log, phase_iters=24)
    _assert_f64_parity(jax_b32, r)
    assert jax_b32["converged"].all()
    # the main path's phases all ran: fundamental, seed, phase 1, rescue
    assert log.trips["setup"] > 0 and log.trips["phase1"] > 0
    assert {"seed", "rescue_phase2", "cold_restart"} <= set(log.seconds)


def test_sweep_device_rescue_overflow_matches_jax(jax_overflow):
    """phase_iters=1 leaves most lanes unconverged; the gathered rescue
    (width 4) takes four and the host _rescue_sweep the rest."""
    log = ht.PhaseLog()
    r = _run_torch(32, "float64", log=log, phase_iters=1, rescue_width=4)
    _assert_f64_parity(jax_overflow, r)
    assert log.trips["rescue_phase2"] > 0
    # the host rescue's trips are counted in its passes, phases inside it
    assert "host_rescue" in log.seconds and log.trips["host_rescue"] == 0
    assert log.trips["rescue_self"] + log.trips.get("rescue_cold", 0) > 0
    assert r.converged.all()


def test_sweep_device_f32_close_to_f64(jax_b64):
    r = _run_torch(64, "float32", phase_iters=24)
    assert r.V_m.dtype == torch.float32
    assert r.converged.all() and jax_b64["converged"].all()
    Vm, Va = r.V_m.double().numpy(), r.V_a.double().numpy()
    assert np.isfinite(Vm).all() and np.isfinite(Va).all()
    assert np.abs(Vm - jax_b64["V_m"]).max() <= VM_TOL_F32
    dV = np.abs(Vm * np.exp(1j * Va)
                - jax_b64["V_m"] * np.exp(1j * jax_b64["V_a"]))
    assert dV.max() <= PHASOR_TOL_F32
