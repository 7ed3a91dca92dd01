"""hpfx_torch.fused_trip (the fused Newton trip, K5) against the JAX
package on the CPU: its constants, one trip of the plain version against
the JAX package's unfused lane-major trip and against the Pallas kernel
(run by Pallas on the CPU), the act = 0 pass-through, the kernel guard
and the whole fused sweep against hpfx.solve.hpf_sweep.  Inputs are made
by numpy from a seed and handed to both packages.  The CUDA kernel itself
is checked on the card by chip_smoke.py."""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import lanes as jl
from hpfx.cx import Cx as JCx
from hpfx.solve import Scenarios as JScen
from hpfx.solve import hpf_sweep as j_sweep
from hpfx.ybus import build_ybus as j_ybus
from hpfx.ybus import line_ybus_pair as j_line_pair
from hpfx_torch import fused_trip as tf
from hpfx_torch.arrow import _make_arrow_consts
from hpfx_torch.ybus import line_ybus_pair

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "hpfx", "data")
sys.path.insert(0, os.path.join(REPO, "validation"))
import fused_trip as jf  # noqa: E402

#: the four configurations of tests/test_fused_trip.py:52-57
CONFIGS = [("net2", True, True), ("net2", False, False), ("net3", True, True),
           ("net1", True, True)]
CONFIG_IDS = ["net2_c_stable", "net2_uc_dense", "net3_c_stable",
              "net1_c_stable"]
#: one f64 trip against the unfused trip: the bounds of
#: tests/test_fused_trip.py:100-104 (the same algorithm; a pivot near-tie
#: on an ill-conditioned random state moves an isolated scenario to ~1e-6)
VM_TOL, VA_TOL, F_REL_TOL = 5e-6, 2e-5, 1e-2
#: against the Pallas kernel: the same elimination with the same pivots
#: in float64, so only summation order differs
PALLAS_TOL = 1e-9
#: the whole float32 fused sweep against the unfused one: the bound of
#: tests/test_fused_trip.py:203, the f32 threshold scale in the phasor
PHASOR_TOL = 5e-4


class Case:
    """Both packages' operands of one configuration, from identical
    inputs: the JAX package's and the port's network, devices, Ybus and
    line structure."""

    def __init__(self, net, coupled, stable, dtype="float64", h_max=25):
        s = hpfx.settings_for_hmax(h_max, coupled=coupled).with_(
            solver="arrow", stable_mismatch=stable, dtype=dtype)
        self.s, self.ts = s, ht.Settings(**dataclasses.asdict(s))
        self.jnet = hpfx.load_network(os.path.join(DATA, f"{net}_buses.csv"),
                                      os.path.join(DATA, f"{net}_lines.csv"),
                                      s)
        self.jdev = hpfx.load_device_set(self.jnet, s)
        rd = self.ts.real_dtype
        tnet, tdev = ht.from_hpfx_arrays(net_leaves(self.jnet),
                                         dev_leaves(self.jdev), device="cpu")
        self.tnet, self.tdev = tnet.to(dtype=rd), tdev.to(dtype=rd)
        self.jY = j_ybus(self.jnet, s)
        self.jlineY = j_line_pair(self.jnet, s)[0]
        self.tY = ht.build_ybus(self.tnet, self.ts)
        self.tlineY = line_ybus_pair(self.tnet, self.ts)[0]
        self.H, self.n = s.n_harmonics, self.jnet.n
        self.m, self.c = self.jnet.m, self.jnet.c

    def consts(self):
        return tf.make_trip_consts(self.tY, self.tlineY, self.tdev, self.tnet,
                                   self.ts, self.ts.real_dtype)

    def state(self, B, seed):
        """The random mid-Newton state of tests/test_fused_trip.py:44-49
        and the loads, as numpy."""
        rng = np.random.default_rng(seed)
        H, n = self.H, self.n
        V_m = np.concatenate([1.0 + 0.05 * rng.standard_normal((1, n, B)),
                              0.1 + 0.02 * rng.standard_normal((H - 1, n, B))])
        V_a = 0.1 * rng.standard_normal((H, n, B))
        inj = np.linspace(0.8, 1.2, B)
        S = (np.asarray(self.jnet.bus_P)[:, None] * np.ones((1, B)),
             np.asarray(self.jnet.bus_Q)[:, None] * np.ones((1, B)))
        return V_m, V_a, inj, S

    def jax_mismatch(self, V_m, V_a, inj, S):
        return jl.mismatch_lanes(jnp.asarray(V_m), jnp.asarray(V_a), self.jY,
                                 JCx(*map(jnp.asarray, S)), self.jdev,
                                 jnp.asarray(inj), self.m, self.n, self.c,
                                 self.jlineY)

    def grouped(self, f):
        """Original-order mismatch rows -> the grouped order."""
        return np.asarray(f)[_make_arrow_consts(
            self.H, self.n, self.m, self.c, torch.float64).inv_f_perm.numpy()]

    def trip_args(self, V_m, V_a, inj, S, f_g, err, act):
        t = lambda a: torch.tensor(np.asarray(a), dtype=self.ts.real_dtype)
        return (t(V_m), t(V_a), t(f_g), t(err)[None], t(act)[None],
                t(S[0]), t(S[1]), t(inj)[None])


def _unfused_trip_jax(case, V_m, V_a, inj, S):
    """One unfused lane-major JAX trip (tests/test_fused_trip.py:76-89):
    (Vm', Va', f', err') in the original row order."""
    H, n, m, c = case.H, case.n, case.m, case.c
    B = V_m.shape[-1]
    f0, _ = case.jax_mismatch(V_m, V_a, inj, S)
    cl = jl._make_arrow_consts(H, n, m, c)
    Vm_j, Va_j = jnp.asarray(V_m), jnp.asarray(V_a)
    dx = jl.arrow_step_lanes(Vm_j, Va_j, f0, case.jY, case.jdev,
                             jnp.asarray(inj), cl)
    D = H * n
    x = jnp.concatenate([Va_j.reshape(D, B)[1:], Vm_j.reshape(D, B)[c:]]) \
        - dx
    Va2 = jnp.concatenate([Va_j.reshape(D, B)[:1], x[:D - 1]]).reshape(H, n,
                                                                       B)
    Vm2 = jnp.concatenate([Vm_j.reshape(D, B)[:c], x[D - 1:]]).reshape(H, n,
                                                                       B)
    f2, err2 = case.jax_mismatch(Vm2, Va2, inj, S)
    return np.asarray(Vm2), np.asarray(Va2), np.asarray(f2), np.asarray(err2)


@pytest.mark.parametrize("net", ["net2", "net3", "net1"])
def test_make_trip_consts_matches_jax(net):
    case = Case(net, True, True)
    jdims, jk = jf.make_trip_consts(case.jY, case.jlineY, case.jdev,
                                    case.jnet, case.s, dtype=jnp.float64)
    dims, k = case.consts()
    assert tuple(dims) == tuple(jdims)
    for name in ("Yr", "Yi", "YNr", "YNi", "INr", "INi", "Ysr", "Ysi", "dr",
                 "di", "lineP"):
        np.testing.assert_array_equal(getattr(k, name).numpy(),
                                      np.asarray(getattr(jk, name)),
                                      err_msg=name)
    # the port indexes the line endpoints where the JAX kernel multiplies
    # by 0/1 incidence masks
    eye = np.eye(case.n)
    np.testing.assert_array_equal(eye[:, k.f_idx.numpy()], np.asarray(jk.Mf))
    np.testing.assert_array_equal(eye[:, k.t_idx.numpy()], np.asarray(jk.Mt))
    np.testing.assert_array_equal(k.lines.numpy(),
                                  np.stack([k.f_idx, k.t_idx]))
    assert k.packed.numel() == sum(
        getattr(k, f).numel() for f in ("Yr", "Yi", "YNr", "YNi", "INr",
                                         "INi", "Ysr", "Ysi", "dr", "di",
                                         "lineP"))


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_trip_ref_matches_unfused_jax(cfg):
    """One f64 trip of the plain version against the JAX package's
    unfused trip (mismatch_lanes, arrow_step_lanes, update) at B=32."""
    case = Case(*cfg)
    B = 32
    V_m, V_a, inj, S = case.state(B, seed=0)
    f0, err0 = case.jax_mismatch(V_m, V_a, inj, S)
    Vm_r, Va_r, f_r, err_r = _unfused_trip_jax(case, V_m, V_a, inj, S)
    dims, k = case.consts()
    Vm2, Va2, f2, err2 = tf.fused_trip_ref(dims, k, *case.trip_args(
        V_m, V_a, inj, S, case.grouped(f0), err0, np.ones(B)))
    assert np.abs(Vm2.numpy() - Vm_r).max() < VM_TOL
    assert np.abs(Va2.numpy() - Va_r).max() < VA_TOL
    scale = np.abs(f_r).max() + 1.0
    assert np.abs(f2.numpy() - case.grouped(f_r)).max() / scale < F_REL_TOL
    assert np.abs(err2[0].numpy() - err_r).max() / scale < F_REL_TOL


def test_trip_ref_matches_pallas_kernel():
    """The plain version against the JAX kernel itself, run by Pallas on
    the CPU, at net2 B=128 in float64: every output of one trip."""
    case = Case("net2", True, True)
    B = 128
    V_m, V_a, inj, S = case.state(B, seed=0)
    f0, err0 = case.jax_mismatch(V_m, V_a, inj, S)
    f0_g = case.grouped(f0)
    act = (np.arange(B) % 4 != 0).astype(np.float64)
    jdims, jk = jf.make_trip_consts(case.jY, case.jlineY, case.jdev,
                                    case.jnet, case.s, dtype=jnp.float64)
    ja = jnp.asarray
    outs_j = jf.fused_trip(jdims, jk, ja(V_m), ja(V_a), ja(f0_g), err0[None],
                           ja(act)[None], ja(S[0]), ja(S[1]), ja(inj)[None],
                           interpret=True)
    dims, k = case.consts()
    outs_t = tf.fused_trip_ref(dims, k, *case.trip_args(
        V_m, V_a, inj, S, f0_g, err0, act))
    for name, j, t in zip(("Vm", "Va", "f", "err"), outs_j, outs_t):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=PALLAS_TOL * (np.abs(j).max() + 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_trip_act_passthrough(dtype):
    """act = 0 lanes keep their state bit for bit; act = 1 lanes get the
    trip of an all-active call."""
    case = Case("net2", True, True, dtype=dtype)
    B = 24
    V_m, V_a, inj, S = case.state(B, seed=1)
    f0, err0 = case.jax_mismatch(V_m, V_a, inj, S)
    dims, k = case.consts()
    act = (np.arange(B) % 3 == 0).astype(np.float64)
    args = case.trip_args(V_m, V_a, inj, S, case.grouped(f0), err0, act)
    outs = tf.fused_trip(dims, k, *args)
    full = tf.fused_trip(dims, k, *case.trip_args(
        V_m, V_a, inj, S, case.grouped(f0), err0, np.ones(B)))
    on = act > 0
    for new, old, ref in zip(outs, args[:4], full):
        assert new.dtype == old.dtype
        assert torch.equal(new[..., ~on], old[..., ~on])
        assert torch.equal(new[..., on], ref[..., on])
        assert not torch.equal(new[..., on], old[..., on])


def test_fused_trip_wrapper_checks():
    case = Case("net2", True, True, dtype="float32")
    B = 4
    V_m, V_a, inj, S = case.state(B, seed=2)
    f0, err0 = case.jax_mismatch(V_m, V_a, inj, S)
    dims, k = case.consts()
    args = list(case.trip_args(V_m, V_a, inj, S, case.grouped(f0), err0,
                               np.ones(B)))
    with pytest.raises(ValueError, match="f has shape"):
        tf.fused_trip(dims, k, *args[:2], args[2][1:], *args[3:])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="several devices"):
        tf.fused_trip(dims, k, *meta)


def test_supports_fused_guard():
    """The kernel takes net2 and net3 (4 buses, one nonlinear) up to
    H = 32 and rejects net1 (n = 20), which the plain version takes on
    the CPU."""
    def dims(net, h_max, coupled=True, stable=True):
        return Case(net, coupled, stable, "float32", h_max).consts()[0]
    for ok in (dims("net2", 25), dims("net3", 25), dims("net2", 25, False),
               dims("net2", 25, True, False), dims("net2", 63)):
        assert tf.supports_fused(ok), ok
    net1 = dims("net1", 51)
    assert (net1.n, net1.r) == (20, 364)
    assert not tf.supports_fused(net1)
    assert not tf.supports_fused(dims("net1", 25))
    assert not tf.supports_fused(dims("net2", 65))    # H = 33
    wide = dims("net2", 25)._replace(L=tf.KERNEL_MAX_L)
    assert tf.supports_fused(wide)
    assert not tf.supports_fused(wide._replace(L=tf.KERNEL_MAX_L + 1))


def test_fused_sweep_matches_jax_sweep():
    """The whole float32 fused sweep against the JAX package's unfused
    lane-major sweep at net2 B=6 (tests/test_fused_trip.py:187-209) and
    against the port's own hpf_sweep: identical convergence flags,
    phasors within PHASOR_TOL, err_hist finite for n_iter trips and NaN
    after them."""
    case = Case("net2", True, True, dtype="float32")
    B = 6
    scen = (np.linspace(0.9, 1.1, B), np.linspace(0.95, 1.05, B),
            np.linspace(0.8, 1.2, B))
    r_j = j_sweep(case.jnet, case.jdev, case.s.with_(layout="lanes"),
                  JScen(*(jnp.asarray(a, jnp.float32) for a in scen)))
    tsc = ht.Scenarios(*(torch.tensor(a, dtype=torch.float32) for a in scen))
    r = tf.fused_sweep(case.tnet, case.tdev, case.ts, tsc)
    r_u = ht.hpf_sweep(case.tnet, case.tdev, case.ts, tsc)
    assert r.V_m.shape == (B, case.H, case.n) and r.V_m.dtype == torch.float32
    conv = r.converged.numpy()
    assert conv.all()
    np.testing.assert_array_equal(conv, np.asarray(r_j.converged))
    np.testing.assert_array_equal(conv, r_u.converged.numpy())
    phasor = lambda Vm, Va: np.asarray(Vm) * np.exp(1j * np.asarray(Va))
    p = phasor(r.V_m.numpy(), r.V_a.numpy())
    assert np.abs(p - phasor(r_j.V_m, r_j.V_a)).max() < PHASOR_TOL
    assert np.abs(p - phasor(r_u.V_m.numpy(), r_u.V_a.numpy())).max() \
        < PHASOR_TOL
    hist, n_iter = r.err_hist.numpy(), r.n_iter.numpy()
    assert hist.shape == (B, case.s.max_iter_h)
    for row, k in zip(hist, n_iter):
        assert k > 0
        assert np.isfinite(row[:k]).all() and np.isnan(row[k:]).all()


def test_fused_sweep_from_v0():
    """V0 (batch-major, as hpf_sweep takes it) is the start: from the
    converged state with its harmonics perturbed, both sweeps take the
    same trips back to the same point."""
    case = Case("net2", True, True, dtype="float32")
    B = 4
    sc = ht.Scenarios(*(torch.linspace(lo, hi, B) for lo, hi in
                        ((0.8, 1.2), (0.8, 1.2), (0.6, 1.4))))
    r0 = ht.hpf_sweep(case.tnet, case.tdev, case.ts, sc)
    V0 = (r0.V_m.clone(), r0.V_a.clone())
    V0[0][:, 1:] *= 1.01
    V0[1][:, 1:] += 0.01
    r = tf.fused_sweep(case.tnet, case.tdev, case.ts, sc, V0=V0)
    r_u = ht.hpf_sweep(case.tnet, case.tdev, case.ts, sc, V0=V0)
    assert r.converged.all() and r_u.converged.all()
    np.testing.assert_array_equal(r.n_iter.numpy(), r_u.n_iter.numpy())
    assert (r.n_iter.numpy() < r0.n_iter.numpy()).all()
    dV = (torch.polar(r.V_m.double(), r.V_a.double())
          - torch.polar(r0.V_m.double(), r0.V_a.double())).abs().max()
    assert dV.item() < PHASOR_TOL


def test_fused_sweep_rejects_per_device_injection():
    case = Case("net2", True, True, dtype="float32")
    one = torch.ones(2)
    with pytest.raises(NotImplementedError, match="per scenario"):
        tf.fused_sweep(case.tnet, case.tdev, case.ts,
                       ht.Scenarios(one, one, torch.ones((2, 1))))
