"""hpfx_torch.parallel (scenario sharding over torch.distributed) against
the JAX package, on the CPU in float64.

A mesh with no process group is this process alone: the sharded calls are
the unsharded ones, bit for bit.  Then 2 and 3 ranks run as the processes
of ``hpfx_torch.entry.dryrun_multichip`` over gloo, each importing only
hpfx_torch, with a ``file://`` store in a temporary directory (no ports),
a 120 s group timeout and 300 s a rank.  Every rank must hold the same
whole result, and rank 0's is held to the JAX package's on the same
scenarios: the sweeps and the hosting-capacity aggregate on the caller's
batch (lanes are independent), the continuation and the adaptive sweep on
the batch padded as the mesh pads it (their chunks and straggler widths
are global, and count the padding)."""
import contextlib
import dataclasses
import io
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx.lanes import (hpf_sweep_adaptive_lanes as j_adaptive,
                        hpf_sweep_continuation_lanes as j_continuation)
from hpfx.solve import Scenarios as JScenarios
from hpfx_torch import parallel as par
from hpfx_torch.entry import dryrun_multichip
from test_torch_foundations import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "hpfx", "data")
NET2 = (os.path.join(DATA, "net2_buses.csv"),
        os.path.join(DATA, "net2_lines.csv"))
B = 13                  # the in-process batch; pads to 15 on 3 ranks
THD_LIMIT = 0.33        # splits this batch: a discriminating aggregate
LIBRARY = ("SMPS", "ev_1")
# float64, net2 H<=5: the two packages' sweeps agree to ~1e-15 pu; the
# adaptive sweep's rescued lanes run up to 15 trips from the cold start
TOL = 1e-12


def _inputs():
    rng = np.random.default_rng(12)
    return dict(p=np.linspace(0.9, 1.1, B), q=np.linspace(0.9, 1.1, B),
                inj=np.linspace(0.3, 1.5, B), ones=np.ones(B),
                inj_nl=rng.uniform(0.6, 1.2, (B, 1)),
                mix=rng.uniform(0.0, 1.0, (B, 1, len(LIBRARY))))


def _jax_setup():
    s = hpfx.settings_for_hmax(5, coupled=True)
    net = hpfx.load_network(*NET2, s)
    return s, net, hpfx.load_device_set(net, s)


def _pad(x, Bp):
    return np.concatenate([x, np.repeat(x[-1:], Bp - len(x), axis=0)])


def _jax_reference(d, world):
    """The JAX package's results on the dry run's scenarios ``d``: the
    sweeps on the caller's batch, the continuation and the adaptive sweeps
    on the batch padded as ``world`` ranks pad it."""
    Bd = len(d["p"])
    Bp = -(-Bd // world) * world
    s, net, dev = _jax_setup()
    sa = s.with_(solver="arrow", layout="lanes")
    J = lambda *xs: JScenarios(*(jnp.asarray(x) for x in xs))
    sc = J(d["p"], d["q"], d["inj"])
    scp = J(*(_pad(d[k], Bp) for k in ("p", "q", "inj")))
    lib = hpfx.load_device_library(LIBRARY, s)
    r = hpfx.solve.hpf_sweep(net, dev, settings=s, scenarios=sc)
    h = hpfx.solve.hosting_capacity_sweep(net, dev, settings=s,
                                          scenarios=sc, thd_limit=THD_LIMIT)
    m = hpfx.solve.hpf_sweep(net, lib, settings=s, scenarios=J(
        np.ones(Bd), np.ones(Bd), d["inj_nl"], d["mix"]))
    c = j_continuation(net, dev, sa, scp, n_stages=3)
    a = jax.jit(partial(j_adaptive, settings=sa, phase_iters=2,
                        rescue_width=2))(net, dev, scenarios=scp)
    w = jax.jit(partial(j_adaptive, settings=sa, phase_iters=2,
                        warm="linear", rescue_width=(2, Bp)))(
        net, dev, scenarios=scp)
    n = lambda x: np.asarray(x)[:Bd]
    two = {}
    if world % 2 == 0:      # the 2-D block: the lanes sweep, unpadded
        r2 = hpfx.solve.hpf_sweep(net, dev, settings=sa, scenarios=J(
            d["p2"], d["q2"], d["inj2"]))
        two = {"2V": np.asarray(r2.V_m), "2conv": np.asarray(r2.converged),
               "2it": np.asarray(r2.n_iter)}
    return dict(**two,
        V=n(r.V_m), conv=n(r.converged), it=n(r.n_iter), hthd=n(h.max_thd_f),
        hconv=n(h.converged), frac=np.asarray(h.frac_over_limit),
        mV=n(m.V_m), mconv=n(m.converged), mit=n(m.n_iter), cV=n(c.V_m),
        cconv=n(c.converged), cit=n(c.n_iter), aV=n(a.V_m),
        aconv=n(a.converged), ait=n(a.n_iter), wV=n(w.V_m),
        wconv=n(w.converged), wit=n(w.n_iter))


def _compare(out, ref):
    two = "2V" in ref
    for k in ("conv", "hconv", "mconv", "cconv", "aconv", "wconv", "it",
              "mit", "cit", "ait", "wit") + (("2conv", "2it") if two else ()):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in ("V", "hthd", "mV", "cV", "aV", "wV") + (("2V",) if two else ()):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=TOL,
                                   err_msg=k)
    assert float(out["frac"]) == float(ref["frac"])


def _leaves(t):
    if t is None:
        return []
    if isinstance(t, torch.Tensor):
        return [t]
    return [x for y in t for x in _leaves(y)]


def test_mesh_alone_is_the_unsharded_sweep():
    """No process group: a mesh of this process alone, whose sharded calls
    equal the unsharded ones bit for bit (no padding, no collective)."""
    mesh = par.scenario_mesh(devices="cpu")
    assert (mesh.size, mesh.index, mesh.world) == (1, 0, 1)
    d = _inputs()
    T = lambda k: torch.tensor(d[k], dtype=torch.float64)
    s = ht.settings_for_hmax(5, coupled=True, dtype="float64")
    sa = s.with_(solver="arrow", layout="lanes")
    net = ht.load_network(*NET2, s, device="cpu")
    dev = ht.load_device_set(net, s)
    sc = ht.Scenarios(T("p"), T("q"), T("inj"))
    pairs = [
        (par.hpf_sweep_sharded(net, dev, s, sc, mesh),
         ht.hpf_sweep(net, dev, s, sc)),
        (par.hosting_capacity_sharded(net, dev, s, sc, mesh, THD_LIMIT),
         ht.hosting_capacity_sweep(net, dev, s, sc, thd_limit=THD_LIMIT)),
        (par.hpf_sweep_continuation_sharded(net, dev, sa, sc, mesh,
                                            n_stages=3),
         ht.hpf_sweep_continuation_lanes(net, dev, sa, sc, n_stages=3)),
        (par.hpf_sweep_adaptive_sharded(net, dev, sa, sc, mesh,
                                        phase_iters=2, rescue_width=2),
         ht.hpf_sweep_adaptive_lanes(net, dev, sa, sc, phase_iters=2,
                                     rescue_width=2))]
    for got, want in pairs:
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):      # NaN-padded histories: NaN == NaN
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_pad_scenarios_repeats_the_last_of_every_field():
    """Every field is padded, per-device scales and device mixes included,
    by repeating the last scenario; the shards are contiguous."""
    d = _inputs()
    T = lambda k: torch.tensor(d[k], dtype=torch.float64)
    sc = ht.Scenarios(T("p"), None, T("inj_nl"), T("mix"))
    mesh = dataclasses.replace(par.scenario_mesh(devices="cpu"),
                               ranks=(0, 1, 2))
    padded, b = par.mesh._pad_scenarios(sc, mesh)
    assert b == B and padded.batch == 15 and padded.q_scale is None
    for x, y in zip(padded, sc):
        if x is not None:
            assert torch.equal(x[:B], y)
            assert torch.equal(x[B:], y[-1:].expand_as(x[B:]))
    shard = par.shard_scenarios(padded, mesh)
    assert torch.equal(shard.p_scale, padded.p_scale[:5])


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """``dryrun_multichip(world, out=...)`` once a world, shared by the
    tests of this module: rank 0's printed report and every rank's
    saves."""
    runs = {}

    def run(world):
        if world not in runs:
            out = tmp_path_factory.mktemp(f"dryrun{world}")
            report = io.StringIO()
            with contextlib.redirect_stdout(report):
                dryrun_multichip(world, out=out)
            runs[world] = report.getvalue(), [
                dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
        return runs[world]

    return run


@pytest.mark.parametrize("world", [2, 3])
def test_gloo_ranks_match_the_reference(world, dryruns):
    """2 and 3 gloo ranks of ``dryrun_multichip`` (each also held to the
    unsharded port): every rank holds the whole result; rank 0's is the
    JAX package's on the same scenarios.  The adaptive sweep's phase 1
    (2 trips) converges no lane, so stragglers lie on every rank; the
    global gather rescues the K = 2 lanes of the whole batch, where a
    per-rank gather would rescue 2 on each rank.  With 2 ranks the dry
    run's 2-D block (hpf_sweep_sharded2d on hpf_mesh(1, 2), B = 5) is
    held to the JAX package's lanes sweep too."""
    _, outs = dryruns(world)
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    out = outs[0]
    assert len(out["p"]) % world != 0       # the padding is exercised
    assert 0.0 < float(out["frac"]) < 1.0
    assert int(out["aconv"].sum()) == 2 and not out["aconv"][2:].any()
    # the straggler masks' gather and one a leaf of the result (12)
    assert int(out["agathers"]) == int(out["wgathers"]) == 13
    _compare(out, _jax_reference(out, world))
    if world == 3:
        np.testing.assert_array_equal(out["subV"], out["V"])
    else:
        assert "2V" in out and out["2conv"].all()


def test_dryrun_multichip_two_ranks(dryruns):
    """The 2-rank dry run (the run of test_gloo_ranks_match_the_reference
    [2]) reports every check of ``__graft_entry__``'s 1-D mesh and its
    2-D block, and the sharded adaptive sweeps' PhaseLog and gather
    spans."""
    out, _ = dryruns(2)
    for what in ("converged batch of 5", "device-mix", "continuation",
                 "adaptive sweep", "warm-seeded adaptive", "2-D (1, 2)",
                 "sweep_sensitivity", "ieee519_screen", "PhaseLog",
                 "13 hpfx.gather spans"):
        assert what in out, out
