"""hpfx_torch.lanes against hpfx.lanes, function by function, at H<=25 and
B=16 in float64 on the CPU, on net2 (coupled and uncoupled) and on net1
(coupled): the setup and fundamental solve, the mismatch and its floor,
the arrow Newton step, the exact-linear seed and the harmonic Newton trip.
Both packages start from the same inputs (hpfx_torch.convert).  In
float64 every solve is LU in both packages; the float32 panel twin is
covered by test_torch_ops.py."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import lanes as jl
from hpfx.solve import Scenarios as JScen
from hpfx_torch import lanes as tl
from hpfx_torch.solve import Scenarios as TScen

from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
B = 16
RTOL = 1e-10
#: net1's Newton transient is chaotic (residuals ~1e2 for about a dozen
#: trips): the two packages' float64 LU solves differ in rounding, and the
#: transient grows that ~10x per trip.  Measured from the seed at this
#: configuration (trips counted from 0): every lane's residual agrees to
#: RTOL_HIST of the residual scale through trip 1 (max 2.8e-11), the first
#: lanes part at trip 2 (2.9e-9), also when both packages start from the
#: same seed, and the final V_m agree to 3.1e-7.  The JAX package's own
#: lanes and vmap layouts part as early as trip 1 on net1.  So on net1
#: the history is held over the first PART_TRIPS trips and the end state
#: to VM_TOL_LOOSE (the LOOSE_ITERS rule of tests/conftest.py)
PART_TRIPS = 2
RTOL_HIST = 1e-9
VM_TOL_LOOSE = 1e-6


def _close(j, t, tol=RTOL, scale=None):
    """|t - j| <= tol * scale, scale = max |j| unless given."""
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape
    if scale is None:
        scale = np.nanmax(np.abs(j))
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


def _res_scale(hist):
    """Residual scale of a Newton run: its largest recorded residual.  A
    converged residual is rounding noise of that size, so residuals are
    held to RTOL of it, not of themselves."""
    return np.nanmax(np.abs(np.asarray(hist)))


class Case:
    """Both packages' setup of one sweep, from identical inputs."""

    def __init__(self, net, coupled):
        s = hpfx.settings_for_hmax(25, coupled=coupled).with_(
            solver="arrow", stable_mismatch=True, big_solve="panel")
        self.s = s
        self.chaotic = net == "net1"
        self.ts = ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64")
        self.jnet = hpfx.load_network(os.path.join(DATA, f"{net}_buses.csv"),
                                      os.path.join(DATA, f"{net}_lines.csv"), s)
        self.jdev = hpfx.load_device_set(self.jnet, s)
        self.tnet, self.tdev = ht.from_hpfx_arrays(
            net_leaves(self.jnet), dev_leaves(self.jdev), device="cpu")
        rng = np.random.default_rng(21)
        p = rng.uniform(0.8, 1.2, B)
        q = rng.uniform(0.8, 1.2, B)
        inj = rng.uniform(0.6, 1.4, (B, self.jnet.n_nonlinear))
        self.jsc = JScen(jnp.asarray(p), jnp.asarray(q), jnp.asarray(inj))
        self.tsc = TScen(*map(torch.tensor, (p, q, inj)))
        self.jsu = jl._sweep_setup(self.jnet, self.jdev, s, self.jsc)
        self.tsu = tl._sweep_setup(self.tnet, self.tdev, self.ts, self.tsc)
        self.jseed = jl._linear_seed_lanes(self.jsu, self.jnet, s)
        self.tseed = tl._linear_seed_lanes(self.tsu, self.tnet, self.ts)

    def state(self):
        """A perturbed mid-Newton state around the seed (both layouts)."""
        rng = np.random.default_rng(5)
        Vm = np.asarray(self.jseed[0]) * (1 + 0.05 * rng.normal(size=(1, 1, B)))
        Va = np.asarray(self.jseed[1]) + 0.05 * rng.normal(size=Vm.shape)
        return (jnp.asarray(Vm), jnp.asarray(Va)), \
            (torch.tensor(Vm), torch.tensor(Va))


@pytest.fixture(scope="module",
                params=[("net2", True), ("net2", False), ("net1", True)],
                ids=["c", "uc", "net1_c"])
def case(request):
    return Case(*request.param)


def test_setup_and_fundamental(case):
    jsu, tsu = case.jsu, case.tsu
    _close(jsu.fund.V_m, tsu.fund.V_m)
    _close(jsu.fund.V_a, tsu.fund.V_a)
    res = _res_scale(jsu.fund.err_hist)
    _close(jsu.fund.err, tsu.fund.err, scale=res)
    _close(jsu.fund.err_hist, tsu.fund.err_hist, scale=res)
    np.testing.assert_array_equal(np.asarray(jsu.fund.n_iter),
                                  tsu.fund.n_iter.numpy())
    np.testing.assert_array_equal(np.asarray(jsu.fund.converged),
                                  tsu.fund.converged.numpy())
    for k in ("cold_V_m", "cold_V_a", "thresh", "inj_db"):
        _close(getattr(jsu, k), getattr(tsu, k))
    _close(jsu.S.re, tsu.S.re)
    _close(jsu.S.im, tsu.S.im)


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "dense"])
def test_mismatch_and_floor(case, stable):
    (jVm, jVa), (tVm, tVa) = case.state()
    n, m, c = case.jnet.n, case.jnet.m, case.jnet.c
    fj, ej = jl.mismatch_lanes(jVm, jVa, case.jsu.Y, case.jsu.S, case.jdev,
                               case.jsu.inj_db, m, n, c,
                               case.jsu.lineY if stable else None)
    ft, et = tl.mismatch_lanes(tVm, tVa, case.tsu.Y, case.tsu.S, case.tdev,
                               case.tsu.inj_db, m, n, c,
                               case.tsu.lineY if stable else None)
    _close(fj, ft)
    _close(ej, et)
    _close(jl.mismatch_floor_lanes(jVm, case.jsu.Y, case.jdev,
                                   case.jsu.inj_db, m, case.s),
           tl.mismatch_floor_lanes(tVm, case.tsu.Y, case.tdev,
                                   case.tsu.inj_db, m, case.ts))


def test_arrow_step(case):
    (jVm, jVa), (tVm, tVa) = case.state()
    n, m, c = case.jnet.n, case.jnet.m, case.jnet.c
    fj, _ = jl.mismatch_lanes(jVm, jVa, case.jsu.Y, case.jsu.S, case.jdev,
                              case.jsu.inj_db, m, n, c, case.jsu.lineY)
    dxj = jl.arrow_step_lanes(jVm, jVa, fj, case.jsu.Y, case.jdev,
                              case.jsu.inj_db, case.jsu.consts,
                              big_solve="panel")
    dxt = tl.arrow_step_lanes(tVm, tVa, torch.tensor(np.asarray(fj)),
                              case.tsu.Y, case.tdev, case.tsu.inj_db,
                              case.tsu.consts, big_solve="panel")
    _close(dxj, dxt)


def test_linear_seed(case):
    _close(case.jseed[0], case.tseed[0])
    _close(case.jseed[1], case.tseed[1])


def test_nr_trip(case):
    j = jl.nr_trip_lanes(case.jsu.Y, case.jsu.lineY, case.jsu.S, case.jdev,
                         case.jsu.inj_db, *case.jseed, case.s,
                         case.jsu.consts, case.jsu.thresh)
    t = tl.nr_trip_lanes(case.tsu.Y, case.tsu.lineY, case.tsu.S, case.tdev,
                         case.tsu.inj_db, *case.tseed, case.ts,
                         case.tsu.consts, case.tsu.thresh)
    res = _res_scale(j[4])
    assert (t[2] <= case.tsu.thresh).all()
    if case.chaotic:
        _close(j[4][:PART_TRIPS], t[4][:PART_TRIPS], RTOL_HIST, scale=res)
        _close(j[0], t[0], VM_TOL_LOOSE, scale=1.0)
        assert (np.asarray(j[2]) <= np.asarray(case.jsu.thresh)).all()
        np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), atol=2)
        return
    _close(j[0], t[0])                                 # V_m
    _close(j[1], t[1])                                 # V_a
    _close(j[2], t[2], scale=res)                      # err
    _close(j[4], t[4], scale=res)                      # err_hist
    np.testing.assert_array_equal(np.asarray(j[3]), t[3].numpy())
