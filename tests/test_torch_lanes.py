"""hpfx_torch.lanes against hpfx.lanes, function by function, at H<=25 and
B=16 in float64 on the CPU, on net2 (coupled and uncoupled) and on net1
(coupled): the setup and fundamental solve, the mismatch and its floor,
the arrow Newton step, the exact-linear seed and the harmonic Newton trip.
Both packages start from the same inputs (hpfx_torch.convert).  In
float64 every solve is LU in both packages; the float32 panel twin is
covered by test_torch_ops.py.  Also the arrow step's capacitance assembly
against the former dense one, at the cells' capacitance shapes."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import hpfx
import hpfx_torch as ht
from hpfx import lanes as jl
from hpfx.solve import Scenarios as JScen
from hpfx_torch import cx, lanes as tl
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


# ---------------------------------------------------------------------------
# the capacitance assembly against the former dense one
# ---------------------------------------------------------------------------

def dense_capacitance_system(K_V, K_A, Gblocks, Vz, lanes):
    """The capacitance assembly as the arrow step made it before its
    d = d' form: the dense coupling matrix C (r, r, b) by an einsum against
    an identity, C·G by a batched product over it, I + C·G, and C·V^T z."""
    H, _, n_nl, _ = K_V.re.shape
    r, r_blk, b = 2 * H * n_nl, 2 * n_nl, lanes.stop - lanes.start
    rd = Vz.dtype
    off = ~torch.eye(H, dtype=torch.bool)[:, :, None, None]
    KV, KA = K_V[..., lanes], K_A[..., lanes]
    zero = torch.zeros_like(KV.re)
    m = lambda x: torch.where(off, x, zero)
    Cfull = torch.stack([torch.stack([m(KA.re), m(KV.re)], dim=-1),
                         torch.stack([m(KA.im), m(KV.im)], dim=-1)], dim=-2)
    eye_d = torch.eye(n_nl, dtype=rd)
    C = torch.einsum("hpdbrc,de->hrdpceb", Cfull, eye_d).reshape(r, r, b)
    CG = torch.einsum("rpsb,pstb->rptb", C.reshape(r, H, r_blk, b),
                      Gblocks[..., lanes])
    S_w = torch.eye(r, dtype=rd)[:, :, None] + CG.reshape(r, r, b)
    return S_w, torch.einsum("rub,ub->rb", C, Vz[:, lanes])


def _assembly_operands(n_nl, dtype, H=13, B=5, seed=3):
    """Random K_V, K_A (H, H, n_nl, B), G blocks (H, 2n_nl, 2n_nl, B) and
    V^T z (r, B), the diagonal h == p terms included (the assembly drops
    them)."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, dtype=dtype)
    K = lambda: cx.Cx(rn(H, H, n_nl, B), rn(H, H, n_nl, B))
    return (K(), K(), rn(H, 2 * n_nl, 2 * n_nl, B),
            20 * rn(2 * H * n_nl, B))


#: the capacitance shapes of the cells at H<=25 (13 harmonics): the IEEE
#: 33-bus feeder (32 nonlinear buses), net1 (7) and net2 (1)
N_NL = {"ieee33bw": 32, "net1": 7, "net2": 1}
#: the whole batch and a rank's share of it under a mesh
LANES = {"all": slice(0, 5), "share": slice(2, 4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("lanes", LANES.values(), ids=LANES.keys())
@pytest.mark.parametrize("n_nl", N_NL.values(), ids=N_NL.keys())
def test_capacitance_system_is_the_dense_one(n_nl, lanes, dtype):
    """S_w = I + C·G and rhs_w = C·V^T z from the d = d' terms against the
    former dense assembly.  Each entry of C·G sums two products, which the
    dense batched product may round in another order: S_w is held to two
    roundings of |C|·|G| + I (on the CPU it comes out bit for bit wherever
    the dense product also summed zeros, n_nl > 1), rhs_w to the rounding
    of its sums."""
    K_V, K_A, G, Vz = _assembly_operands(n_nl, dtype)
    S_w, rhs = tl._capacitance_system_lanes(K_V, K_A, G, Vz, lanes)
    S_ref, rhs_ref = dense_capacitance_system(K_V, K_A, G, Vz, lanes)
    assert S_w.shape == S_ref.shape and S_w.is_contiguous()
    absK = lambda k: cx.Cx(k.re.abs(), k.im.abs())
    S_abs, _ = dense_capacitance_system(absK(K_V), absK(K_A), G.abs(), Vz,
                                        lanes)
    eps = torch.finfo(dtype).eps
    assert ((S_w - S_ref).abs() <= 2 * eps * S_abs).all()
    if n_nl > 1:
        assert torch.equal(S_w, S_ref)
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    scale = float(rhs_ref.abs().max())
    torch.testing.assert_close(rhs, rhs_ref, rtol=tol, atol=tol * scale)


class _LargeOutputs(TorchDispatchMode):
    """Counts the operations whose output holds at least ``size``
    elements in storage of its own (not a view of an input)."""

    def __init__(self, size):
        super().__init__()
        self.size, self.ops = size, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr()
               for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.numel() >= self.size \
                    and t.untyped_storage().data_ptr() not in ins:
                self.ops.append(func._schema.name)
        return out


@pytest.mark.parametrize("n_nl", [N_NL["ieee33bw"], N_NL["net1"]],
                         ids=["ieee33bw", "net1"])
def test_capacitance_system_allocates_s_w_alone(n_nl):
    """The assembly makes one tensor of r·r·b elements, S_w, and writes it
    in place: no dense C, no C·G, no permuted copy of either.  (At one
    nonlinear bus the coupling terms alone hold r·r·b.)"""
    K_V, K_A, G, Vz = _assembly_operands(n_nl, torch.float32)
    r, b = Vz.shape
    with _LargeOutputs(r * r * b) as seen:
        tl._capacitance_system_lanes(K_V, K_A, G, Vz, slice(0, b))
    assert seen.ops == ["aten::new_empty"]
