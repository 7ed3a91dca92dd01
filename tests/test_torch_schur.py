"""The panel-Schur solve of the port (hpfx_torch.ops.batched_solve.
schur_solve_lanes) against the JAX package's on the CPU: the block algebra
with an LU leaf, the default leaf (the direct kernels' plain twin) against
the Pallas kernel's leaf, the capacitance-accuracy gate of
tests/test_ops.py, the dispatcher's routes under every impl and HPFX_SCHUR
mode, the direct kernels' launch at any number of right-hand sides, and
big_solve="schur" and "warmup" through the sweeps.

The JAX package takes LU for every float32 lanes solve on the CPU
(hpfx/ops/batched_solve.py:772-773), whatever ``impl`` says, so the sweep
comparison sends JAX's impl="schur" solves to its schur_solve_lanes with a
Gauss-Jordan leaf here, in the test, and leaves its other solves as they
are."""
import dataclasses
import functools
import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx.lanes as jlanes
import hpfx_torch as ht
from hpfx.solve import Scenarios as JScen
from hpfx_torch import solve as tsolve
from hpfx_torch.ops import batched_solve as tbs

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_ops import F32_TOL, PAST_ONE_BLOCK, _plan_ok

# the module (hpfx.ops re-exports a function of the same name)
jbs = importlib.import_module("hpfx.ops.batched_solve")

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
#: the block algebra with an LU leaf: float64 against the JAX package's,
#: relative to the solution's scale; float32 against numpy's float64 LU
#: (the bound of tests/test_ops.py:test_schur_solve_lanes_algebra)
ALGEBRA_RTOL_F64 = 1e-12
ALGEBRA_ATOL_F32 = 2e-4
#: the sweep from a perturbed warm start, port against JAX, in float32 on
#: the lanes both converge: the JAX package's own net1 float32 gate
#: (tests/test_f32_path.py:114; measured 4e-5 at B=8)
SWEEP_VM_TOL = 3e-4
#: the warm start: float64 converged voltages with V_m scaled by up to
#: this (seeded), so that the Newton steps are few and not chaotic (from
#: the cold start float32 Schur steps part within a few trips: counts
#: 25/22/19 against 15/18/16 measured)
WARM_PERTURB = 0.05
#: the largest dynamic plus static shared memory of one block (bytes)
SMEM_LIMIT = 232448


def _systems(n, R, B, seed, dtype=np.float64):
    """Diagonally boosted random systems (tests/test_ops.py:140-142)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n, B)) + 0.1 * n * np.eye(n)[:, :, None]
    b = rng.normal(size=(n, R, B))
    return A.astype(dtype), b.astype(dtype)


def _capacitance(n, B, seed):
    """I + C, the arrow solver's capacitance system
    (tests/test_ops.py:163-165)."""
    rng = np.random.default_rng(seed)
    A = np.eye(n)[:, :, None] + rng.normal(size=(n, n, B)) * (0.8 / np.sqrt(n))
    return A, rng.normal(size=(n, 1, B))


def _np_solve(A, b):
    return np.stack([np.linalg.solve(A[..., i].astype(np.float64),
                                     b[..., i].astype(np.float64))
                     for i in range(A.shape[-1])], axis=-1)


def _port_schur(leaf=None, panel=tbs.SCHUR_PANEL):
    return tbs.equilibrated_lanes(functools.partial(
        tbs.schur_solve_lanes, leaf=leaf, panel=panel))


def _jax_schur(leaf, panel):
    return jax.jit(jbs.equilibrated_lanes(functools.partial(
        jbs.schur_solve_lanes, leaf=leaf, panel=panel)))


@pytest.mark.parametrize("n,B,R,panel", [(182, 8, 1, 48), (150, 4, 3, 48),
                                         (364, 2, 1, 96), (136, 4, 2, 64)])
def test_block_algebra_matches_jax(n, B, R, panel):
    """The cases of tests/test_ops.py:test_schur_solve_lanes_algebra
    (recursion deeper than 4 levels, dims past the direct kernels), each
    package with its own LU leaf so that only the block algebra is held."""
    A, b = _systems(n, R, B, seed=n + R)
    x_j = np.asarray(_jax_schur(jbs._lu_solve_lanes, panel)(
        jnp.asarray(A), jnp.asarray(b)))
    x_t = _port_schur(tbs._lu_solve_lanes, panel)(torch.tensor(A),
                                                  torch.tensor(b)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=ALGEBRA_RTOL_F64 * np.abs(x_j).max())
    A32, b32 = torch.tensor(A, dtype=torch.float32), torch.tensor(
        b, dtype=torch.float32)
    ref = _np_solve(A32.numpy(), b32.numpy())
    x32 = _port_schur(tbs._lu_solve_lanes, panel)(A32, b32)
    assert x32.dtype == torch.float32
    np.testing.assert_allclose(x32.numpy(), ref, rtol=0,
                               atol=ALGEBRA_ATOL_F32 * np.abs(ref).max())


def test_default_leaf_matches_pallas():
    """The default leaf on the CPU (the direct kernels' plain twin, no
    equilibration inside) against the JAX package's default, the Pallas
    kernel run by Pallas on the CPU, at n = 140 and panel 32 (leaves of
    dim 32 with 109, 77, 45 and 13 right-hand sides, then dim 12), within
    the bound of test_torch_ops.py:test_ref_matches_pallas."""
    A, b = _capacitance(140, 4, seed=140)
    A, b = A.astype(np.float32), b.astype(np.float32)
    leaf = functools.partial(jbs.gauss_solve_pallas_lanes, interpret=True)
    x_j = np.asarray(_jax_schur(leaf, 32)(jnp.asarray(A), jnp.asarray(b)))
    x_t = _port_schur(panel=32)(torch.tensor(A), torch.tensor(b)).numpy()
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=F32_TOL * scale)
    np.testing.assert_allclose(x_t, _np_solve(A, b), rtol=0,
                               atol=F32_TOL * scale)


@pytest.mark.parametrize("leaf,panel", [("lu", 48), ("default", 32)])
def test_capacitance_accuracy_gate(leaf, panel):
    """tests/test_ops.py:test_schur_solve_capacitance_accuracy on the port:
    on I + C systems of dim 182 the float32 panel-Schur solve stays within
    2.5x of the fully pivoted solve's error from float64 LU, and below
    1e-4 of the solution's scale; with the JAX test's LU leaf and panel
    48, and as batched_solve_lanes(impl="schur") takes it (the default
    leaf, panel 32)."""
    A64, b64 = _capacitance(182, 16, seed=182)
    ref = _np_solve(A64, b64)
    A32 = torch.tensor(A64, dtype=torch.float32)
    b32 = torch.tensor(b64, dtype=torch.float32)
    x_direct = tbs.equilibrated_lanes(tbs._lu_solve_lanes)(A32, b32).numpy()
    if leaf == "lu":
        x_schur = _port_schur(tbs._lu_solve_lanes, panel)(A32, b32)
    else:
        x_schur = tbs.batched_solve_lanes(A32, b32, impl="schur")
        np.testing.assert_array_equal(x_schur.numpy(),
                                      _port_schur()(A32, b32).numpy())
    scale = np.abs(ref).max()
    err_direct = np.abs(x_direct - ref).max() / scale
    err_schur = np.abs(x_schur.numpy() - ref).max() / scale
    assert err_schur < 1e-4, err_schur
    assert err_schur <= max(2.5 * err_direct, 5e-6), (err_schur, err_direct)


#: the JAX dispatcher's route functions and the port's that stand for them
_ROUTES = {"_lu_solve_lanes": "_lu_solve_lanes",
           "gj_solve_xla_lanes": "gj_solve_lanes_ref",
           "schur_solve_lanes": "schur_solve_lanes",
           "panel_gj_solve_lanes": "panel_gj_solve_lanes",
           "gauss_solve_pallas_lanes": "equilibrated_gauss_solve_lanes"}


@functools.lru_cache(maxsize=None)
def _route_operands(n):
    A = np.eye(n, dtype=np.float32)[:, :, None]
    return A, np.ones((n, 1, 1), np.float32)


@pytest.mark.parametrize("mode", ["1", "mid", "0"])
@pytest.mark.parametrize("n", [130, 200, 4100])
@pytest.mark.parametrize("impl", ["auto", "direct", "panel", "schur"])
def test_dispatch_routes_as_jax(monkeypatch, impl, n, mode):
    """batched_solve_lanes takes the route the JAX dispatcher takes on its
    TPU for every impl, HPFX_SCHUR mode (the module constants
    monkeypatched) and dim: 130 (a blocked route by choice), 200 (past the
    direct kernels) and 4100 (4104 padded rows at width 8, past
    MAX_PANEL_DIM and the reference's 3184: LU).  Each route function is
    replaced by a recorder in both packages, and the JAX module sees a
    TPU backend."""
    seen = {"jax": [], "torch": []}

    def recorder(pkg, name, zeros):
        return lambda A, b, **kw: (seen[pkg].append(name), zeros(b))[1]
    for j, t in _ROUTES.items():
        monkeypatch.setattr(jbs, j, recorder("jax", t, jnp.zeros_like))
        monkeypatch.setattr(tbs, t, recorder("torch", t, torch.zeros_like))
    monkeypatch.setattr(jbs, "jax", types.SimpleNamespace(
        default_backend=lambda: "tpu"))
    monkeypatch.setattr(jbs, "USE_PALLAS_SOLVE", True)
    monkeypatch.setattr(jbs, "SCHUR_MODE", mode)
    monkeypatch.setattr(tbs, "SCHUR_MODE", mode)
    A, b = _route_operands(n)
    jbs.batched_solve_lanes(jnp.asarray(A), jnp.asarray(b), impl=impl)
    tbs.batched_solve_lanes(torch.from_numpy(A), torch.from_numpy(b),
                            impl=impl)
    assert len(seen["jax"]) == 1 and seen["torch"] == seen["jax"], seen


@pytest.mark.parametrize("n", [8, 22, 32, 40, 64])
def test_chunked_plan_covers_every_width(n):
    """Every R from 1 to 3200 (the leaves of a dim-3184 Schur solve carry
    up to ~3150) has one launch: chunks of ``chunk`` columns that cover R
    exactly, as few as fit, each within one block's shared memory (at dim
    64, gj_kernel_carried's register slots); up to the widest chunk it is
    launch_plan(n, R) itself, one chunk."""
    widest = tbs._widest_chunk(n)
    with pytest.raises(ValueError, match=PAST_ONE_BLOCK):
        tbs.launch_plan(n, widest + 1)
    for R in range(1, 3201):
        p, chunk = tbs.chunked_plan(n, R)
        chunks = -(-R // chunk)
        assert 1 <= chunk <= min(R, widest)
        assert (chunks - 1) * chunk < R <= chunks * chunk
        assert chunks == -(-R // widest)
        assert p == _plan_ok(n, chunk)
        if R <= widest:
            assert chunk == R
        if p.kernel == "gj_kernel":
            static = 4 * p.systems * (2 * p.slots + 32 * p.rows)
        else:
            nw = p.threads // 32
            static = 4 * (2 * nw * p.slots + 6 * nw + p.rows)
        assert p.smem + static <= SMEM_LIMIT


def test_schur_leaf_widths_launch_in_one_call():
    """What chunked_plan answers: at dim 32 one block holds
    at most 209 right-hand sides, and net1 H<=51's first leaf (r = 364)
    has 333; its one launch is two chunks of 167."""
    assert tbs._widest_chunk(32) == 209
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tbs.launch_plan(32, 210)
    assert tbs.chunked_plan(32, 333)[1] == 167
    assert tbs.chunked_plan(32, 151) == (tbs.launch_plan(32, 151), 151)


# ---- the sweeps -----------------------------------------------------------

def _net1_h19():
    """net1 capped at H<=19, coupled: a capacitance system of dim 140
    (> SCHUR_MIN_DIM), the arrow solver on the lanes layout.  Returns
    the JAX settings and network in float32, and the port's network in
    float64 (loaded by the JAX package in float64)."""
    s = hpfx.settings_for_hmax(19, coupled=True).with_(
        solver="arrow", stable_mismatch=True, layout="lanes")
    paths = (os.path.join(DATA, "net1_buses.csv"),
             os.path.join(DATA, "net1_lines.csv"))
    jnet = hpfx.load_network(*paths, s)
    net, dev = ht.from_hpfx_arrays(
        net_leaves(jnet), dev_leaves(hpfx.load_device_set(jnet, s)),
        device="cpu")
    s = s.with_(dtype="float32")
    jnet = hpfx.load_network(*paths, s)
    return s, jnet, hpfx.load_device_set(jnet, s), net, dev


def _draws(Bt):
    return (np.linspace(0.8, 1.2, Bt), np.linspace(0.8, 1.2, Bt),
            np.linspace(0.6, 1.4, Bt))


@pytest.fixture(scope="module")
def net1_h19():
    return _net1_h19()


@pytest.fixture(scope="module")
def f64_solution(net1_h19):
    """The port's float64 solution of the 8 scenarios (LU throughout)."""
    s, _, _, net, dev = net1_h19
    ts = ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64",
                                                    big_solve="panel")
    r = ht.hpf_sweep(net, dev, ts, ht.Scenarios(*map(torch.tensor,
                                                     _draws(8))))
    assert r.converged.all()
    return r


@pytest.fixture(scope="module")
def warm_start(f64_solution):
    """The float64 solution, V_m perturbed by up to WARM_PERTURB (seeded),
    in float32."""
    r = f64_solution
    rng = np.random.default_rng(19)
    Vm = r.V_m.numpy() * (1 + WARM_PERTURB * rng.uniform(-1, 1, r.V_m.shape))
    return Vm.astype(np.float32), r.V_a.numpy().astype(np.float32)


def _tame(err_hist):
    """The scenarios whose residual falls at every recorded trip: Newton
    in its basin, where rounding moves a count by at most one trip."""
    return np.array([bool((np.diff(h[np.isfinite(h)]) < 0).all())
                     for h in err_hist])


def _count_schur(monkeypatch):
    """Count the port's panel-Schur solves (the dispatcher's global)."""
    calls = []
    inner = tbs.schur_solve_lanes

    def counted(A, b, *a, **kw):
        calls.append(tuple(A.shape))
        return inner(A, b, *a, **kw)
    monkeypatch.setattr(tbs, "schur_solve_lanes", counted)
    return calls


@pytest.mark.parametrize("big_solve", ["schur", "warmup"])
def test_sweep_matches_jax(monkeypatch, net1_h19, warm_start, big_solve):
    """hpf_sweep at net1 H<=19 B=8 in float32 with big_solve="schur" (every
    trip solves the dim-140 capacitance system by panel-Schur) and
    "warmup" (its first 2 trips; "direct" after) from a perturbed warm
    start, against the JAX package with its impl="schur" solves sent to
    its own schur_solve_lanes with the unrolled-XLA Gauss-Jordan leaf:
    identical converged flags, V_m within SWEEP_VM_TOL where both
    converge, counts within 1 trip on the scenarios whose residual falls at
    every trip of the JAX run (:func:`_tame`).  One scenario is not tame:
    a small in-panel pivot makes its first Schur step differ between the
    two packages by tens of percent (residual 1.67 against 1.03 after it),
    it diverges in both under "schur" and converges in both under
    "warmup", after 7 trips in JAX and 11 here."""
    s, jnet, jdev, net, dev = net1_h19
    s = s.with_(big_solve=big_solve, big_solve_warmup=2)
    orig = jlanes.batched_solve_lanes
    jax_impls = set()

    def jax_solve(A, b, impl="auto"):
        jax_impls.add((A.shape[0], impl))
        if impl == "schur" and A.dtype == jnp.float32 \
                and A.shape[0] > jbs.SCHUR_MIN_DIM:
            return jbs.equilibrated_lanes(functools.partial(
                jbs.schur_solve_lanes, leaf=jbs.gj_solve_xla_lanes))(A, b)
        return orig(A, b, impl)
    monkeypatch.setattr(jlanes, "batched_solve_lanes", jax_solve)
    Vm0, Va0 = warm_start
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    j = hpfx.solve.hpf_sweep(jnet, jdev, s, JScen(*map(f32, _draws(8))),
                             V0=(f32(Vm0), f32(Va0)))
    want = {(140, "schur")} | ({(140, "direct")} if big_solve == "warmup"
                               else set())
    assert want <= jax_impls

    calls = _count_schur(monkeypatch)
    ts = ht.Settings(**dataclasses.asdict(s))
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    net, dev = net.to(dtype=torch.float32), dev.to(dtype=torch.float32)
    r = ht.hpf_sweep(net, dev, ts, ht.Scenarios(*map(t, _draws(8))),
                     V0=(t(Vm0), t(Va0)))
    assert calls and set(calls) == {(140, 140, 8)}
    if big_solve == "warmup":
        assert len(calls) == 2
    conv = r.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(j.converged))
    assert conv.sum() >= 6
    tame = _tame(np.asarray(j.err_hist))
    assert tame.sum() >= 6
    assert np.abs(r.n_iter.numpy() - np.asarray(j.n_iter))[tame].max() <= 1
    Vm = r.V_m.numpy()
    assert np.isfinite(Vm[conv]).all()
    np.testing.assert_allclose(Vm[conv], np.asarray(j.V_m)[conv], rtol=0,
                               atol=SWEEP_VM_TOL)


@pytest.mark.parametrize("entry,big_solve", [("adaptive", "schur"),
                                             ("device", "warmup")])
def test_sweep_entry_points_take_schur(monkeypatch, net1_h19, f64_solution,
                                       entry, big_solve):
    """hpf_sweep_adaptive and hpf_sweep_device run big_solve="schur" and
    "warmup" from the cold start in float32 and solve the capacitance
    system by panel-Schur (no host rescue: it re-solves the stragglers in
    float64, which takes LU); the lanes they flag converged are finite and
    within the float32 gate of the float64 solution.  Their convergence is
    not held: the panel-restricted pivoting leaves some scenarios
    unconverged, as on the reference (Settings.big_solve)."""
    s, _, _, net, dev = net1_h19
    calls = _count_schur(monkeypatch)
    ts = ht.Settings(**dataclasses.asdict(s)).with_(dtype="float32",
                                                    big_solve=big_solve)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    sc = ht.Scenarios(*map(t, _draws(8)))
    n32, d32 = net.to(dtype=torch.float32), dev.to(dtype=torch.float32)
    run = ht.hpf_sweep_adaptive if entry == "adaptive" \
        else tsolve.hpf_sweep_device
    r = run(n32, d32, ts, sc, phase_iters=24, warm="cold", rescue=False)
    assert calls and set(c[0] for c in calls) == {140}
    conv = r.converged.numpy()
    assert conv.any()
    Vm = r.V_m.numpy()[conv]
    assert np.isfinite(Vm).all()
    assert np.abs(Vm - f64_solution.V_m.numpy()[conv]).max() <= SWEEP_VM_TOL


@pytest.mark.parametrize("name", ["hpf_sweep", "hosting_capacity_sweep"])
def test_unjitted_names_are_the_sweeps(name):
    """hpf_sweep_unjitted and hosting_capacity_sweep_unjitted (the JAX
    package's bodies of its jitted sweeps) give the sweeps' results bit
    for bit: the port never jits, so each is the body its counterpart
    runs."""
    s = ht.settings_for_hmax(5, coupled=True, dtype="float64")
    net = ht.load_network(os.path.join(DATA, "net2_buses.csv"),
                          os.path.join(DATA, "net2_lines.csv"), s,
                          device="cpu")
    dev = ht.load_device_set(net, s)
    sc = ht.Scenarios(p_scale=torch.linspace(0.8, 1.2, 4,
                                             dtype=torch.float64))
    got = getattr(tsolve, name + "_unjitted")(net, dev, s, sc)
    want = getattr(tsolve, name)(net, dev, s, sc)
    got, want = _tensors(got), _tensors(want)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        bits = {torch.float64: torch.int64, torch.float32: torch.int32}
        if g.dtype in bits:        # NaN-padded histories, bit for bit
            g, w = g.view(bits[g.dtype]), w.view(bits[w.dtype])
        assert torch.equal(g, w)


def _tensors(x):
    """The tensors of a result, nested named tuples included, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []
