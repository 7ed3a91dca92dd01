"""The port's single-scenario solver and its batch-major (vmap) sweep on the
CPU: hpfx_torch.hpf, solve_fundamental, the first-iteration pieces and the
arrow step against the golden fixtures and the JAX package in float64;
report, voltage_phasors and waveform against the JAX functions; the
batch-major dispatcher (batched_solve, solve_blocks, nr_solve) against the
JAX package's; hpf_sweep's vmap layout and hpf_sweep_adaptive with a dense
phase 2 against the JAX package's; and the layout rule."""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx.solve import Scenarios as JScen
from hpfx.solve import hpf_sweep as j_sweep
from hpfx.solve import hpf_sweep_adaptive as j_adaptive
from hpfx_torch import harmonic as th
from hpfx_torch import solve as tsolve
from hpfx_torch.cx import Cx
from hpfx_torch.ops import batched_solve as tbs

from conftest import (DIVERGED, LOOSE_ITERS, SHALLOW_STOP, config_id,
                      load_golden)
from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)

# the module (hpfx.ops re-exports a function of the same name)
jbs = importlib.import_module("hpfx.ops.batched_solve")

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
#: float64 port against float64 JAX: the same arithmetic up to the order
#: of sums and LAPACK's rounding, ~1e-13 on these configurations
V_TOL_F64 = 1e-10
#: float32 elimination error bound of tests/test_ops.py:27, relative to
#: the solution's scale
F32_TOL = 3e-5
#: float32 port against float32 JAX on the vmap sweep (the port's solves
#: are the kernels' Gauss-Jordan twins, JAX's on the CPU equilibrated LU):
#: the bounds phases 4 and 6 of chip_smoke.py hold float32 to float64 to
#: (|dV_m| and phasor |dV|, pu)
VM_TOL_F32 = 5e-5
PHASOR_TOL_F32 = 1e-4


def _paths(name):
    return (os.path.join(DATA, f"{name}_buses.csv"),
            os.path.join(DATA, f"{name}_lines.csv"))


def _port_setup(cfg, **kw):
    """The port's float64 settings, network and devices of a golden
    configuration, loaded from the CSVs onto the CPU."""
    name, h, coupled = cfg
    ts = ht.settings_for_hmax(h, coupled=coupled, dtype="float64", **kw)
    net = ht.load_network(*_paths(name), ts, device="cpu")
    return ts, net, ht.load_device_set(net, ts)


def _jax_setup(cfg, **kw):
    """The JAX package's settings, network and devices, and the port's
    built from the same arrays (float64)."""
    name, h, coupled = cfg
    s = hpfx.settings_for_hmax(h, coupled=coupled, **kw)
    jnet = hpfx.load_network(*_paths(name), s)
    jdev = hpfx.load_device_set(jnet, s)
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    ts = ht.Settings(**dataclasses.asdict(s))
    ts = ts.with_(dtype=kw.get("dtype", "float64"))
    return s, jnet, jdev, ts, net, dev


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _angle_diff(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


# ---------------------------------------------------------------------------
# the golden fixtures (the gate of tests/test_harmonic.py and
# tests/test_fundamental.py)
# ---------------------------------------------------------------------------

def test_first_iteration_parity(config):
    """Mismatch, state vector and dense Jacobian at the warm-started first
    harmonic iteration against the reference, entry for entry."""
    g = load_golden(config)
    ts, net, dev = _port_setup(config)
    Y = ht.build_ybus(net, ts)
    fund = ht.pf(Y, net, ts)
    V_m, V_a = th.init_harmonic_voltages(fund, net, ts)
    f0, err0 = th.harmonic_mismatch(V_m, V_a, Y, Cx(net.bus_P, net.bus_Q),
                                    dev, net.m, net.n, net.c)
    x0 = th.harmonic_state_vector(V_m, V_a, net.c)
    J0 = th.build_harmonic_jacobian(V_m, V_a, Y, dev, net.m, net.n, net.c)
    _close(f0, g["f0"], 1e-10)
    _close(x0, g["x0"], 1e-12)
    _close(J0, g["J0"], 1e-9)
    np.testing.assert_allclose(float(err0), float(g["err_h0"]), rtol=1e-9)


def test_hpf_golden_gate(config):
    """Final voltages and THD within 1e-8 of the reference with identical
    iteration counts, under the exception sets of tests/conftest.py."""
    g = load_golden(config)
    ts, net, dev = _port_setup(config)
    res = ht.hpf(net, dev, ts)
    n_iter, V_m, V_a = int(res.n_iter), res.V_m.numpy(), res.V_a.numpy()
    if config in DIVERGED:
        assert n_iter == int(g["n_iter_h"]) == ts.max_iter_h
        assert not bool(res.converged)
        return
    thd = ht.get_thd(res.V_m)
    if config in SHALLOW_STOP:
        assert abs(n_iter - int(g["n_iter_h"])) <= 6
        assert bool(res.converged)
        assert float(res.err) <= float(g["err_h"])
        _close(V_m, g["V_m"], 2e-7)
        _close(V_a, g["V_a"], 5e-6)
        _close(thd.THD_F, g["THD_F"], 1e-6)
        _close(thd.THD_R, g["THD_R"], 1e-6)
        return
    if config in LOOSE_ITERS:
        assert abs(n_iter - int(g["n_iter_h"])) <= 6
        _close(V_m, g["V_m"], 1e-10)
        _close(V_a, g["V_a"], 1e-10)
    else:
        assert n_iter == int(g["n_iter_h"])
    assert bool(res.converged)
    _close(V_m, g["V_m"], 1e-8)
    _close(V_a, g["V_a"], 1e-8)
    _close(thd.THD_F, g["THD_F"], 1e-8)
    _close(thd.THD_R, g["THD_R"], 1e-8)


def test_solve_fundamental_golden(config):
    """The fundamental solve against V_fund_m, V_fund_a and n_iter_f (the
    gate of tests/test_fundamental.py)."""
    g = load_golden(config)
    ts, net, _ = _port_setup(config)
    res = ht.solve_fundamental(ht.build_ybus(net, ts)[0], net, ts)
    assert int(res.n_iter) == int(g["n_iter_f"])
    assert bool(res.converged)
    _close(res.V_m, g["V_fund_m"], 1e-10)
    _close(res.V_a, g["V_fund_a"], 1e-10)
    hist = res.err_hist.numpy()[: int(res.n_iter)]
    np.testing.assert_allclose(hist, g["err_f_t"], rtol=1e-4, atol=1e-12)


def test_default_settings_run():
    """Settings()'s defaults (solver "dense", layout "auto", float32 in the
    port, H<=51) run through hpf, hpf_single and hpf_sweep on the CPU."""
    ts = ht.Settings()
    net = ht.load_network(*_paths("net2"), ts, device="cpu")
    dev = ht.load_device_set(net, ts)
    for res in (ht.hpf(net, dev, ts), ht.hpf_single(net, dev, ts)):
        assert res.V_m.shape == (ts.n_harmonics, net.n)
        assert res.V_m.dtype == torch.float32
        assert bool(res.converged) and bool(torch.isfinite(res.V_m).all())
    one = torch.ones(2)
    res = ht.hpf_sweep(net, dev, ts, ht.Scenarios(one, one, one))
    assert res.V_m.shape == (2, ts.n_harmonics, net.n)
    assert bool(res.converged.all())


# ---------------------------------------------------------------------------
# the arrow step and the results API against the JAX package
# ---------------------------------------------------------------------------

#: net1 H<=5 runs uncoupled: coupled, the reference itself diverges there
#: (DIVERGED); the H<=25 cases take the stable mismatch
ARROW_CASES = [("net2", 5, True), ("net3", 5, True), ("net1", 5, False),
               ("net2", 25, True), ("net3", 25, True), ("net1", 25, True)]


@pytest.mark.parametrize("cfg", ARROW_CASES, ids=config_id)
def test_arrow_single_matches_jax(cfg):
    """hpf_single with solver="arrow" against the JAX package's in float64:
    identical counts, voltages to 1e-10."""
    s, jnet, jdev, ts, net, dev = _jax_setup(
        cfg, solver="arrow", stable_mismatch=cfg[1] == 25)
    rj = hpfx.hpf_single(jnet, jdev, s)
    rt = ht.hpf_single(net, dev, ts)
    assert int(rt.n_iter) == int(rj.n_iter)
    assert int(rt.fund.n_iter) == int(rj.fund.n_iter)
    assert bool(rt.converged) and bool(rj.converged)
    _close(rt.V_m, rj.V_m, V_TOL_F64)
    assert _angle_diff(rt.V_a.numpy(), np.asarray(rj.V_a)).max() <= V_TOL_F64


def test_report_and_waveform_match_jax():
    """report, voltage_phasors, waveform and waveform_metrics against the
    JAX functions on the same result (JAX's hpf_single on net2 H<=5), to
    1e-12."""
    from hpfx import results as jr
    s, jnet, jdev, ts, _, _ = _jax_setup(("net2", 5, True))
    rj = hpfx.hpf_single(jnet, jdev, s)
    t = lambda a: torch.tensor(np.asarray(a))
    rt = ht.HPFResult(*(t(x) for x in rj[:6]),
                      fund=ht.FundResult(*(t(x) for x in rj.fund)))
    a, b = jr.report(rj, s), ht.report(rt, ts)
    assert a.harmonics == b.harmonics
    for k in ("n_iter_fund", "n_iter_harm", "err_fund", "err_harm",
              "converged"):
        assert getattr(a, k) == getattr(b, k), k
    for x, y in ((a.V_m, b.V_m), (a.V_a, b.V_a), (a.thd.THD_F, b.thd.THD_F),
                 (a.thd.THD_R, b.thd.THD_R)):
        _close(y, x, 1e-12)
    np.testing.assert_array_equal(np.isnan(b.residual_history.numpy()),
                                  np.isnan(np.asarray(a.residual_history)))
    _close(ht.voltage_phasors(rt.V_m, rt.V_a),
           jr.voltage_phasors(rj.V_m, rj.V_a), 1e-12)
    for n_s in (64, 1000):
        (th_j, v_j), (th_t, v_t) = (
            jr.waveform(rj.V_m, rj.V_a, s.harmonics, n_s),
            ht.waveform(rt.V_m, rt.V_a, s.harmonics, n_s))
        _close(th_t, th_j, 1e-12)
        _close(v_t, v_j, 1e-12)
    mj = jr.waveform_metrics(rj.V_m, rj.V_a, s.harmonics)
    mt = ht.waveform_metrics(rt.V_m, rt.V_a, s.harmonics)
    for x, y in zip(mj, mt):
        _close(y, x, 1e-12)


def test_warm_start_and_trajectory_match_jax():
    """hpf from a V0 (the fundamental of the cold start, harmonics at
    half their golden values) with record_trajectory, against the JAX
    package's in float64: counts, voltages and every recorded iterate to
    1e-10, NaN past the last one."""
    cfg = ("net2", 25, True)
    s, jnet, jdev, ts, net, dev = _jax_setup(cfg)
    g = load_golden(cfg)
    Vm0, Va0 = g["V_m"].copy(), g["V_a"].copy()
    Vm0[1:] *= 0.5
    rj = hpfx.hpf(jnet, jdev, s, V0=(jnp.asarray(Vm0), jnp.asarray(Va0)),
                  record_trajectory=True)
    rt = ht.hpf(net, dev, ts, V0=(torch.tensor(Vm0), torch.tensor(Va0)),
                record_trajectory=True)
    assert int(rt.n_iter) == int(rj.n_iter) > 0
    _close(rt.V_m, rj.V_m, V_TOL_F64)
    tj, tt = np.asarray(rj.trajectory), rt.trajectory.numpy()
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(tj))
    _close(np.nan_to_num(tt), np.nan_to_num(tj), V_TOL_F64)
    _close(tt[0], np.stack([Vm0, Va0]), 0.0)


def test_ybus_override_and_ydiag_match_jax():
    """hpf with a dense Y override equals the built admittances' solve
    (the stable mismatch off); Y_diag folded into the admittances and the
    line structure, with the stable mismatch on, against the JAX
    package's in float64."""
    cfg = ("net2", 5, True)
    ts, net, dev = _port_setup(cfg)
    base = ht.hpf(net, dev, ts)
    over = ht.hpf(net, dev, ts, Y=ht.build_ybus(net, ts))
    assert int(over.n_iter) == int(base.n_iter)
    torch.testing.assert_close(over.V_m, base.V_m, rtol=0, atol=0)
    s, jnet, jdev, ts, net, dev = _jax_setup(cfg, stable_mismatch=True)
    rng = np.random.default_rng(4)
    yd = [rng.uniform(0.0, 0.05, (s.n_harmonics, net.n)) for _ in range(2)]
    rj = hpfx.hpf(jnet, jdev, s,
                  Y_diag=hpfx.Cx(*(jnp.asarray(a) for a in yd)))
    rt = ht.hpf(net, dev, ts, Y_diag=Cx(*(torch.tensor(a) for a in yd)))
    assert int(rt.n_iter) == int(rj.n_iter)
    _close(rt.V_m, rj.V_m, V_TOL_F64)
    _close(rt.V_m.numpy() * np.exp(1j * rt.V_a.numpy()),
           np.asarray(rj.V_m) * np.exp(1j * np.asarray(rj.V_a)), V_TOL_F64)


# ---------------------------------------------------------------------------
# the batch-major dispatcher against the JAX package's
# ---------------------------------------------------------------------------

def _bm_systems(B, n, R, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)) + 3.0 * np.sqrt(n) * np.eye(n)
    # rows scaled over 1e-2..1e2, as the equilibration sees HPF Jacobians
    A = A * 10.0 ** rng.uniform(-2, 2, (B, n, 1))
    b = rng.normal(size=(B, n) if R is None else (B, n, R))
    return A.astype(dtype), b.astype(dtype)


def _jax_tpu_branch(A, b):
    """The JAX dispatcher's TPU branch, run on the CPU: equilibrated
    gauss_solve_pallas (by Pallas on the CPU) up to dim 192, the
    equilibrated blocked panel solve past it."""
    def panel(A_, b_):
        multi = b_.ndim == 3
        b3 = b_ if multi else b_[..., None]
        x = jbs.panel_gj_solve_lanes(jnp.moveaxis(A_, 0, -1),
                                     jnp.moveaxis(b3, 0, -1), interpret=True)
        x = jnp.moveaxis(x, -1, 0)
        return x if multi else x[..., 0]

    def direct(A_, b_):
        return jbs.gauss_solve_pallas(A_, b_, interpret=True)
    solve = direct if A.shape[-1] <= jbs.MAX_PALLAS_DIM else panel
    return np.asarray(jbs.equilibrated(solve)(jnp.asarray(A),
                                              jnp.asarray(b)))


#: the dims of this path: the fundamental Jacobian of net2 (6), the dense
#: Jacobians of net2 H<=5 (22) and H<=25 (102), and one past the direct
#: kernels' 192 (the blocked solve, K4)
@pytest.mark.parametrize("n", [6, 22, 102, 200])
def test_batched_solve_matches_jax(n):
    """batched_solve in float64 (raw LU on both sides, to 1e-12 of the
    solution's scale) and in float32 (the kernels' twins against the JAX
    package's Pallas kernels through their own CPU route, to F32_TOL of
    the solution's scale, both also against float64 LU)."""
    for R in (None, 3):
        A, b = _bm_systems(4, n, R, seed=n)
        A64, b64 = A.astype(np.float64), b.astype(np.float64)
        x64 = tbs.batched_solve(torch.tensor(A64), torch.tensor(b64)).numpy()
        ref = np.asarray(jbs.batched_solve(jnp.asarray(A64), jnp.asarray(b64)))
        scale = np.abs(ref).max()
        _close(x64, ref, 1e-12 * scale)
        x32 = tbs.batched_solve(torch.tensor(A), torch.tensor(b))
        assert x32.dtype == torch.float32 and x32.shape == b.shape
        _close(x32.numpy(), _jax_tpu_branch(A, b), F32_TOL * scale)
        _close(x32.numpy(), ref, F32_TOL * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_solve_blocks_and_nr_solve_match_jax(dtype):
    """solve_blocks and nr_solve on a batch (the JAX functions under vmap)
    and on one system, at the arrow blocks' shape of net2 (dim 8, 3
    right-hand sides) and net2 H<=5's dense Jacobian (dim 22)."""
    tol = 1e-12 if dtype == np.float64 else F32_TOL
    D, rhs = _bm_systems(3 * 5, 8, 3, seed=1, dtype=dtype)
    D, rhs = D.reshape(3, 5, 8, 8), rhs.reshape(3, 5, 8, 3)
    ref = np.asarray(jax.vmap(jbs.solve_blocks)(jnp.asarray(D),
                                                jnp.asarray(rhs)))
    scale = np.abs(ref).max()
    _close(tbs.solve_blocks(torch.tensor(D), torch.tensor(rhs)).numpy(), ref,
           tol * scale)
    _close(tbs.solve_blocks(torch.tensor(D[0]), torch.tensor(rhs[0])).numpy(),
           ref[0], tol * scale)
    J, f = _bm_systems(6, 22, None, seed=2, dtype=dtype)
    ref = np.asarray(jax.vmap(jbs.nr_solve)(jnp.asarray(J), jnp.asarray(f)))
    scale = np.abs(ref).max()
    _close(tbs.nr_solve(torch.tensor(J), torch.tensor(f)).numpy(), ref,
           tol * scale)
    _close(tbs.nr_solve(torch.tensor(J[0]), torch.tensor(f[0])).numpy(),
           ref[0], tol * scale)


def test_batch_major_route_takes_the_kernels(monkeypatch):
    """float32 dims up to 192 go to the direct kernels' wrapper (dim 6 and
    22 too: no split at dim 16) on one batch-last copy, larger ones to the
    blocked solve on the batch-major operands as they stand, past the
    panel kernel's rows to LU; float64 to LU."""
    seen = []
    monkeypatch.setattr(tbs, "equilibrated_gauss_solve_lanes",
                        lambda A, b: seen.append(("gj", A.shape,
                                                  A.is_contiguous())) or b)
    monkeypatch.setattr(tbs, "panel_gj_solve_lanes",
                        lambda A, b: seen.append(("panel", A.shape,
                                                  A.is_contiguous())) or b)
    monkeypatch.setattr(tbs, "_lu_solve",
                        lambda A, b: seen.append(("lu", A.shape)) or b)
    for n in (6, 22, 192, 193, 5000):
        A = torch.ones(1).expand(2, n, n)
        tbs.batched_solve(A, torch.ones((2, n)))
    tbs.batched_solve(torch.ones((2, 6, 6), dtype=torch.float64),
                      torch.ones((2, 6), dtype=torch.float64))
    assert seen == [("gj", (6, 6, 2), True), ("gj", (22, 22, 2), True),
                    ("gj", (192, 192, 2), True),
                    ("panel", (193, 193, 2), False),
                    ("lu", (2, 5000, 5000)), ("lu", (2, 6, 6))]


# ---------------------------------------------------------------------------
# the vmap sweep and the adaptive sweep with a dense phase 2
# ---------------------------------------------------------------------------

def _scenarios(B, n, n_nl, seed, dtype):
    """Mixed scales: per-bus p, per-scenario q, per-device injections."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.8, 1.2, (B, n))
    q = rng.uniform(0.8, 1.2, B)
    inj = rng.uniform(0.6, 1.4, (B, n_nl)) if n_nl else rng.uniform(0.6, 1.4, B)
    j = JScen(*(jnp.asarray(a.astype(dtype)) for a in (p, q, inj)))
    t = ht.Scenarios(*(torch.tensor(a.astype(dtype)) for a in (p, q, inj)))
    return j, t


def _sweeps(cfg, B, dtype, seed=3, net_fn=None, **kw):
    if dtype == np.float32:
        kw["dtype"] = "float32"
    s, jnet, jdev, ts, net, dev = _jax_setup(cfg, layout="vmap", **kw)
    if net_fn is not None:
        jnet, jdev, net, dev = net_fn(s, jnet)
    js, tsc = _scenarios(B, net.n, net.n - net.m, seed, dtype)
    return j_sweep(jnet, jdev, s, js), ht.hpf_sweep(net, dev, ts, tsc)


def _same_sweep(rj, rt, tol, hist_trips=None):
    """Counts, flags and voltages identical up to ``tol``; residual
    histories NaN where JAX's are and within 1e-6, over the first
    ``hist_trips`` trips (all by default)."""
    np.testing.assert_array_equal(rt.n_iter.numpy(), np.asarray(rj.n_iter))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.fund.n_iter.numpy(),
                                  np.asarray(rj.fund.n_iter))
    assert bool(rt.converged.all())
    Vm_j, Va_j = np.asarray(rj.V_m), np.asarray(rj.V_a)
    _close(rt.V_m, Vm_j, tol)
    # the angle is held through the phasor: an unsourced harmonic sits at
    # ~1e-17 pu with an arbitrary angle, and a small one's angle moves by
    # the rounding over its magnitude
    _close(rt.V_m.numpy() * np.exp(1j * rt.V_a.numpy()),
           Vm_j * np.exp(1j * Va_j), tol)
    hj, ht_ = np.asarray(rj.err_hist), rt.err_hist.numpy()
    np.testing.assert_array_equal(np.isnan(ht_), np.isnan(hj))
    np.testing.assert_allclose(ht_[:, :hist_trips], hj[:, :hist_trips],
                               rtol=1e-6, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("cfg,B", [(("net2", 5, True), 8),
                                   (("net1", 5, False), 4)],
                         ids=["net2_h5_c_B8", "net1_h5_uc_B4"])
def test_vmap_sweep_matches_jax_f64(cfg, B):
    """The batch-major loop against JAX's vmap layout in float64: per-
    scenario counts and converged flags identical, voltages to 1e-10."""
    _same_sweep(*_sweeps(cfg, B, np.float64), V_TOL_F64)


def test_vmap_sweep_matches_jax_f32():
    """The same in float32 at bench.py's settings (stable mismatch, floor-
    aware test): the same converged flags, voltages within VM_TOL_F32 and
    phasors within PHASOR_TOL_F32 of JAX's float32 sweep, and counts
    within 6, LOOSE_ITERS' bound: near the float32 floor the last
    iterations hover, and where they stop follows the rounding of the
    solves (the port's against JAX's differ by up to 5 here, by the same
    with JAX's Pallas kernels in place of its LU)."""
    rj, rt = _sweeps(("net2", 5, True), 8, np.float32, stable_mismatch=True)
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    assert bool(rt.converged.all())
    assert np.abs(rt.n_iter.numpy() - np.asarray(rj.n_iter)).max() <= 6
    Vm_j, Va_j = np.asarray(rj.V_m), np.asarray(rj.V_a)
    _close(rt.V_m, Vm_j, VM_TOL_F32)
    dV = np.abs(rt.V_m.numpy() * np.exp(1j * rt.V_a.numpy())
                - Vm_j * np.exp(1j * Va_j)).max()
    assert dV <= PHASOR_TOL_F32


def _no_devices(s, jnet):
    """net2 with its nonlinear bus taken as a PQ load: no Norton device."""
    jnet = dataclasses.replace(jnet, m=jnet.n,
                               bus_types=jnet.bus_types[:-1] + (2,))
    jdev = hpfx.load_device_set(jnet, s)
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    return jnet, jdev, net, dev


def test_vmap_sweep_without_devices_matches_jax():
    """An empty device set (the layout "auto" takes too) against JAX's
    vmap layout in float64."""
    rj, rt = _sweeps(("net2", 5, True), 4, np.float64, net_fn=_no_devices)
    _same_sweep(rj, rt, V_TOL_F64)


def test_adaptive_dense_phase2_matches_jax():
    """hpf_sweep_adaptive with phase 1 on the arrow solver (lane-major
    layout) and phase 2 on the dense solver (vmap layout), phase 1 capped
    at 6 trips so that phase 2 re-solves stragglers, against the JAX
    package's in float64: identical counts, voltages to the golden gate's
    1e-8.  The two lane-major phase 1s sum in other orders, and the
    Newton transient of these scenarios multiplies that rounding ~10x a
    trip (to 1e-2 of the residual at trip 13, ~2e-9 pu in the voltages at
    the stop), so the residual histories are held over the first 3
    trips."""
    s, jnet, jdev, ts, net, dev = _jax_setup(
        ("net2", 25, True), solver="arrow", layout="lanes",
        stable_mismatch=True)
    js, tsc = _scenarios(8, net.n, net.n - net.m, 5, np.float64)
    rj = j_adaptive(jnet, jdev, s, js, phase_iters=6,
                    phase2_settings=s.with_(solver="dense"))
    rt = ht.hpf_sweep_adaptive(net, dev, ts, tsc, phase_iters=6,
                               phase2_settings=ts.with_(solver="dense"))
    assert (rt.n_iter.numpy() > 6).any()
    _same_sweep(rj, rt, 1e-8, hist_trips=3)


@pytest.mark.parametrize("layout,solver,devices,route", [
    ("auto", "arrow", True, "lanes"), ("lanes", "arrow", True, "lanes"),
    ("auto", "dense", True, "vmap"), ("auto", "arrow", False, "vmap"),
    ("lanes", "arrow", False, "vmap"), ("vmap", "arrow", True, "vmap")])
def test_sweep_layout_rule(monkeypatch, layout, solver, devices, route):
    """"auto" and "lanes" take the lane-major path with the arrow solver
    and Norton devices, the vmap loop otherwise; "vmap" always the loop."""
    taken = []
    monkeypatch.setattr(tsolve, "hpf_sweep_lanes",
                        lambda *a, **k: taken.append("lanes"))
    monkeypatch.setattr(tsolve, "_hpf_sweep_vmap",
                        lambda *a, **k: taken.append("vmap"))
    ts, net, dev = _port_setup(("net2", 5, True), layout=layout,
                               solver=solver)
    if not devices:
        dev = dataclasses.replace(dev, I_N=dev.I_N[:0], Y_N=dev.Y_N[:0])
    one = torch.ones(2, dtype=torch.float64)
    ht.hpf_sweep(net, dev, ts, ht.Scenarios(one, one, one))
    assert taken == [route]


def test_unknown_devices_raise_type_error():
    """A devices that is none of DeviceSet, AnalyticDeviceSet and
    DeviceLibrary raises TypeError, naming the types it takes."""
    ts, net, dev = _port_setup(("net2", 5, True))
    with pytest.raises(TypeError, match="DeviceSet, AnalyticDeviceSet"):
        ht.hpf(net, object(), ts)
