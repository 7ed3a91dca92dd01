"""The port's analysis layers against the JAX package, on the CPU:
resonance mode analysis (modes), the unbalanced three-phase solve
(threephase) and the extended-Jacobian HPF with controlled devices
(extended, the devices written once per library and carried across by
hpfx_torch.convert.controlled_from_hpfx_arrays).

Tolerances: float64 eigenpairs, impedances and phase voltages within
F64_TOL of their scale, sensitivities to rtol 1e-8; host-side outputs
(modal_spectrum on the same matrix, allocation draws) exactly; the
extended Newton with identical iterations and voltages and unknowns
within 1e-10; float32 against the JAX float32 path within F32_TOL pu."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import cx as jcx
from hpfx import modes as jmodes
from hpfx.devices import norton_inject as j_norton_inject
from hpfx.extended import ControlledDeviceSet as JControlled
from hpfx_torch import cx as tcx
from hpfx_torch import modes as tmodes

from test_torch_continuation import pair32
from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_sweep_api import close, pair, to_np

F64_TOL = 1e-10
F32_TOL = 1e-4
#: a modal grid of 8 points over orders 2-25 (validation/bench_modes3p.py's
#: 128, cut)
GRID = tuple(np.round(np.linspace(2.0, 25.0, 8), 6))


def cx_close(t, j, tol=F64_TOL):
    scale = max(1.0, float(np.abs(np.asarray(j.re)).max()),
                float(np.abs(np.asarray(j.im)).max()))
    close(t.re, np.asarray(j.re), tol * scale)
    close(t.im, np.asarray(j.im), tol * scale)


def j_of(z):
    return jcx.Cx(jnp.asarray(z.real), jnp.asarray(z.imag))


def t_of(z):
    return tcx.Cx(torch.tensor(z.real), torch.tensor(z.imag))


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "nonsym"])
def test_critical_mode_matches(symmetric):
    """The smallest eigenpair of seeded (5, 6, 6) complex matrices:
    eigenvalue, phase-fixed vectors, participations and residuals; and
    modal_spectrum bit for bit on the same matrix."""
    rng = np.random.default_rng(8)
    A = rng.normal(size=(5, 6, 6)) + 1j * rng.normal(size=(5, 6, 6))
    if symmetric:
        A = A + np.swapaxes(A, -1, -2)
    mj = jmodes.critical_mode(j_of(A), iters=16, symmetric=symmetric)
    mt = tmodes.critical_mode(t_of(A), iters=16, symmetric=symmetric)
    for f in ("lam", "v", "w", "participation"):
        cx_close(getattr(mt, f), getattr(mj, f))
    close(mt.residual, np.asarray(mj.residual), 1e-12)
    for a, b in zip(ht.modal_spectrum(t_of(A[0])),
                    hpfx.modal_spectrum(j_of(A[0]))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["net2", "net3"])
def test_modal_scan_matches(name):
    """modal_scan on an 8-point grid over orders 2-25 with the devices'
    Norton diagonal interpolated in (iters=16, the harness's), and
    modal_peaks: the same peaks, orders and critical buses."""
    P = pair(name, 25)
    sj = hpfx.modal_scan(P.jnet, P.s, h_grid=GRID, devices=P.jdev, iters=16)
    st = ht.modal_scan(P.net, P.ts, h_grid=GRID, devices=P.dev, iters=16)
    close(st.order, np.asarray(sj.order), 0.0)
    np.testing.assert_allclose(to_np(st.z_modal), np.asarray(sj.z_modal),
                               rtol=F64_TOL)
    cx_close(st.lam, sj.lam)
    close(st.participation, np.asarray(sj.participation), F64_TOL)
    np.testing.assert_array_equal(to_np(st.critical_bus),
                                  np.asarray(sj.critical_bus))
    for a, b in zip(ht.modal_peaks(st), hpfx.modal_peaks(sj)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_modal_scan_f32():
    """float32 on net2 against the JAX float32 scan: z_modal within F32_TOL
    relative, the same peaks."""
    s, jnet, jdev, ts, net, dev = pair32("net2", 25)
    sj = hpfx.modal_scan(jnet, s, h_grid=GRID, devices=jdev, iters=16)
    st = ht.modal_scan(net, ts, h_grid=GRID, devices=dev, iters=16)
    np.testing.assert_allclose(to_np(st.z_modal), np.asarray(sj.z_modal),
                               rtol=F32_TOL)
    np.testing.assert_array_equal(to_np(ht.modal_peaks(st)[0]),
                                  np.asarray(hpfx.modal_peaks(sj)[0]))


def test_eigen_sensitivity_matches():
    """d lambda/dp and dz_modal for every line and shunt parameter through
    build_ybus (torch.func.jacrev against jax.jacrev), with the devices'
    diagonal folded in, at a fractional order."""
    P = pair("net3", 25)
    lj, sj = hpfx.eigen_sensitivity(P.jnet, P.s, 6.5, devices=P.jdev)
    lt, st = ht.eigen_sensitivity(P.net, P.ts, 6.5, devices=P.dev)
    cx_close(lt, lj)
    def rel(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=1e-8,
                                   atol=1e-12 * np.abs(want).max())

    for k, d in sj.items():
        rel(st[k]["dlam"].re, d["dlam"].re)
        rel(st[k]["dlam"].im, d["dlam"].im)
        rel(st[k]["dz_modal"], d["dz_modal"])


# ---------------------------------------------------------------------------
# three-phase
# ---------------------------------------------------------------------------

ABC = dict(r0_scale=2.5, x0_scale=3.0)


def abc_draws(n_nl, D=8, seed=2000):
    """validation/bench_modes3p.py's draws: magnitude 1 + 0.3·N(0, 1),
    angle 0.2·N(0, 1)."""
    rng = np.random.default_rng(seed)
    return (1.0 + 0.3 * rng.standard_normal((D, n_nl, 3)),
            0.2 * rng.standard_normal((D, n_nl, 3)))


def test_abc_admittance_and_injections_match():
    """Y_abc with a blocked line and a grounded neutral; the per-phase
    injections with a delta device and per-phase factors."""
    P = pair("net1", 5, coupled=False)
    kw = dict(blocked=(2,), bus_Xg={4: 0.2}, **ABC)
    cx_close(ht.abc_admittance(P.net, P.ts, **kw),
             hpfx.abc_admittance(P.jnet, P.s, **kw))
    mag, ang = abc_draws(P.jdev.n_devices, 1)
    ij = hpfx.phase_injections(P.jdev, P.s, delta=(1,), mag=mag[0],
                               ang=ang[0])
    it = ht.phase_injections(P.dev, P.ts, delta=(1,), mag=mag[0], ang=ang[0])
    cx_close(it, ij)


@pytest.mark.parametrize("coupled", [False, True],
                         ids=["uncoupled", "coupled"])
def test_solve_unbalanced_matches(coupled):
    """8 draws at net1 H<=5: the port's one batched solve against the JAX
    package's per-draw solves (a delta device, the h-diagonal of coupled
    devices), sequence voltages and unbalance factors; and without the
    slack grounded."""
    P = pair("net1", 5, coupled=coupled)
    mag, ang = abc_draws(P.jdev.n_devices)
    rt = ht.solve_unbalanced(P.net, P.dev, P.ts, delta=(2,), mag=mag,
                             ang=ang, **ABC)
    ut = ht.unbalance_factors(rt)
    for d in range(len(mag)):
        rj = hpfx.solve_unbalanced(P.jnet, P.jdev, P.s, delta=(2,),
                                   mag=mag[d], ang=ang[d], **ABC)
        cx_close(rt.V[d], rj.V)
        for a, b in zip(ht.sequence_voltages(rt), hpfx.sequence_voltages(rj)):
            cx_close(a[d], b)
        for a, b in zip(ut, hpfx.unbalance_factors(rj)):
            close(a[d], np.asarray(b), F64_TOL)
    rj = hpfx.solve_unbalanced(P.jnet, P.jdev, P.s, ground_slack=False)
    rt = ht.solve_unbalanced(P.net, P.dev, P.ts, ground_slack=False)
    cx_close(rt.V[1:], rj.V[1:])


def test_solve_unbalanced_f32():
    """float32 against the JAX float32 solve, 8 draws at net1 H<=5
    uncoupled: within F32_TOL pu."""
    s, jnet, jdev, ts, net, dev = pair32("net1", 5)
    s = s.with_(coupled=False)
    jdev = hpfx.load_device_set(jnet, s)
    _, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                 device="cpu")
    dev = dev.to(dtype=torch.float32)
    ts = ts.with_(coupled=False)
    mag, ang = abc_draws(jdev.n_devices)
    rt = ht.solve_unbalanced(net, dev, ts, mag=mag, ang=ang, **ABC)
    for d in range(len(mag)):
        rj = hpfx.solve_unbalanced(jnet, jdev, s, mag=mag[d], ang=ang[d],
                                   **ABC)
        close(rt.V.re[d], np.asarray(rj.V.re), F32_TOL)
        close(rt.V.im[d], np.asarray(rj.V.im), F32_TOL)


def test_allocation_study_and_flows_match():
    """allocation_study (the same seeded numpy draws, solved in one batch)
    and line_phase_flows of one solve."""
    P = pair("net1", 5, coupled=False)
    kw = dict(n_draws=8, seed=3, q=(0.5, 0.9), delta=(1,), **ABC)
    aj = hpfx.allocation_study(P.jnet, P.jdev, P.s, **kw)
    at = ht.allocation_study(P.net, P.dev, P.ts, **kw)
    for f in ("q", "u0_q", "u2_q", "vmag_q", "orders"):
        close(getattr(at, f), np.asarray(getattr(aj, f)), F64_TOL)
    mag, ang = abc_draws(P.jdev.n_devices, 1)
    rj = hpfx.solve_unbalanced(P.jnet, P.jdev, P.s, blocked=(3,),
                               mag=mag[0], ang=ang[0], **ABC)
    rt = ht.solve_unbalanced(P.net, P.dev, P.ts, blocked=(3,), mag=mag[0],
                             ang=ang[0], **ABC)
    fj = hpfx.line_phase_flows(P.jnet, P.s, rj, blocked=(3,), **ABC)
    ft = ht.line_phase_flows(P.net, P.ts, rt, blocked=(3,), **ABC)
    cx_close(ft.I_f, fj.I_f)
    cx_close(ft.I_t, fj.I_t)
    close(ft.residual_f, np.asarray(fj.residual_f), F64_TOL)
    close(ft.residual_rms, np.asarray(fj.residual_rms), F64_TOL)


# ---------------------------------------------------------------------------
# extended
# ---------------------------------------------------------------------------

#: the power setpoints of the controlled device: net2's is
#: tests/test_extended.py's (2% above its nominal 9.018); net3's 9.1 is 1.2%
#: above its nominal 8.991 (at 9.17 and 9.2 the float64 transient wanders
#: 26-50 trips with residuals ~1e2 and the two packages part)
P_SET = {"net2": 9.2, "net3": 9.1}


def j_inject(params, V_m, V_a, u):
    """tests/test_extended.py's controlled device: the Norton injection
    scaled by (1 + u)."""
    I_N, Y_N, _ = params
    return j_norton_inject((I_N, Y_N), V_m, V_a) * (1.0 + u[0])


def j_constraint(params, V_m, V_a, u):
    """Its closure: the fundamental active power draw at the setpoint."""
    I = j_inject(params, V_m, V_a, u)
    V1 = jcx.polar(V_m[0:1], V_a[0:1])
    return jnp.array([-(V1 * I[0:1].conj()).re[0] - params[2]])


def t_inject(params, V_m, V_a, u):
    I_N, Y_N, _ = params
    return ht.norton_inject((I_N, Y_N), V_m, V_a) * (1.0 + u[0])


def t_constraint(params, V_m, V_a, u):
    I = t_inject(params, V_m, V_a, u)
    V1 = tcx.polar(V_m[0:1], V_a[0:1])
    return (-(V1 * I[0:1].conj()).re[0] - params[2])[None]


def _controlled(P, p_set):
    """The controlled device in both packages: the JAX one from
    tests/test_extended.py:56, the port's carried from its arrays."""
    jparams = (P.jdev.I_N, P.jdev.Y_N, jnp.asarray([p_set]))
    jc = JControlled(params=jparams, u0=jnp.zeros((1, 1)), inject=j_inject,
                     constraint=j_constraint, n_nl=1, n_u=1)
    tc = ht.controlled_from_hpfx_arrays(
        (jparams[0].to_numpy(), jparams[1].to_numpy(),
         np.asarray(jparams[2])), np.asarray(jc.u0), t_inject, t_constraint,
        n_nl=1, n_u=1, device="cpu")
    return jc, tc


@pytest.mark.parametrize("name", ["net2", "net3"])
def test_hpf_extended_matches(name):
    """The control unknown solved to its power setpoint at H<=5 in
    float64: identical iterations, voltages and u within 1e-10."""
    P = pair(name, 5)
    jc, tc = _controlled(P, P_SET[name])
    rj = hpfx.hpf_extended(P.jnet, jc, P.s)
    rt = ht.hpf_extended(P.net, tc, P.ts)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.n_iter) == int(rj.n_iter)
    close(rt.V_m, np.asarray(rj.V_m), 1e-10)
    close(rt.u, np.asarray(rj.u), 1e-10)
    assert abs(float(rt.u[0, 0])) > 1e-4


def test_controlled_device_carried_from_arrays():
    """A ControlledDeviceSet carried across by controlled_from_hpfx_arrays
    (complex params to split-complex, u0) holds the JAX arrays bit for
    bit, and with the inert injection and pinning constraint
    (tests/test_extended.py:35) gives the plain hpf's result in float64
    as the JAX package's does."""
    P = pair("net2", 5)
    jc, tc = _controlled(P, P_SET["net2"])
    np.testing.assert_array_equal(tc.params[0].re.numpy(),
                                  np.asarray(P.jdev.I_N.re))
    np.testing.assert_array_equal(tc.params[1].im.numpy(),
                                  np.asarray(P.jdev.Y_N.im))
    assert tc.u0.shape == (1, 1) and tc.n_u == 1
    inert = ht.controlled_from_hpfx_arrays(
        (P.jdev.I_N.to_numpy(), P.jdev.Y_N.to_numpy()), np.zeros((1, 2)),
        lambda p, vm, va, u: ht.norton_inject(p, vm, va),
        lambda p, vm, va, u: u, n_nl=1, n_u=2, device="cpu")
    jinert = JControlled(params=(P.jdev.I_N, P.jdev.Y_N),
                         u0=jnp.zeros((1, 2)),
                         inject=lambda p, vm, va, u: j_norton_inject(p, vm,
                                                                     va),
                         constraint=lambda p, vm, va, u: u, n_nl=1, n_u=2)
    rt = ht.hpf_extended(P.net, inert, P.ts)
    rj = hpfx.hpf_extended(P.jnet, jinert, P.s)
    plain = ht.hpf(P.net, P.dev, P.ts)
    assert int(rt.n_iter) == int(rj.n_iter) == int(plain.n_iter)
    close(rt.V_m, np.asarray(rj.V_m), 1e-10)
    close(rt.V_m, plain.V_m, 1e-10)
    close(rt.u, 0.0 * np.asarray(rj.u), 1e-12)
