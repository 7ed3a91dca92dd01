"""The harmonic axis of hpfx_torch.parallel (``harmonic_mesh``,
``hpf_mesh``, ``hpf_single_hsharded``, ``hpf_sweep_sharded2d`` and the 2-D
meshes of the adaptive and continuation sweeps) against the unsharded
port and the JAX package, on the CPU in float64 at net2 H<=5 (H = 3).

One spawn of 4 gloo ranks (this file run as a script: it imports only
hpfx_torch there, and JAX only inside the tests) runs every sharded case
and saves each rank's results; every rank must hold the same result, and
rank 0's is held to the unsharded port (the same arithmetic lane by lane:
bit for bit, or within ``SAME_TOL``, with identical counts and flags) and
to the JAX package's unsharded functions (1e-12).  ``harmonic_mesh(4)``
(the single case) and ``hpf_mesh(1, 4)`` (the lanes sweep) split H = 3
as 1, 1, 1, 0: the last rank holds no harmonic and takes part in every
collective all the same."""
import datetime
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import hpfx_torch as ht
from hpfx_torch import lanes as tl, parallel as par
from hpfx_torch.entry import GROUP_TIMEOUT_S, RANK_TIMEOUT_S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "hpfx", "data")
NET2 = (os.path.join(DATA, "net2_buses.csv"),
        os.path.join(DATA, "net2_lines.csv"))
WORLD = 4
B = 2 * WORLD + 1           # not a multiple of the 2-rank scenario axis
SAME_TOL = 1e-12            # sharded against unsharded port (entry.py's)
TOL = 1e-12                 # against the JAX package (test_torch_parallel)
SINGLE_TOL = 1e-10          # against JAX's hpf_single_hsharded
FIELDS = ("V_m", "V_a", "err", "n_iter", "converged")
SWEEPS = ("sweep2d", "adaptive", "continuation")
#: hpf_sweep_sharded2d on hpf_mesh(1, 4): a rank without a harmonic in
#: the lane-major trip; held to sweep2d's references
EMPTY_RANK = "sweep2d_h4"
CASES = SWEEPS + (EMPTY_RANK, "single_arrow", "single_dense")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread (test_torch_foundations' fixture, not
    imported from there: that module imports JAX, and the ranks run this
    file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    return dict(p=np.linspace(0.9, 1.1, B), q=np.linspace(0.95, 1.05, B),
                inj=np.linspace(0.3, 1.5, B))


def _port_setup():
    s = ht.settings_for_hmax(5, coupled=True, dtype="float64")
    net = ht.load_network(*NET2, s, device="cpu")
    return s, net, ht.load_device_set(net, s)


def _scenarios(d, Bp=None):
    """The port's scenarios, padded to ``Bp`` by repeating the last."""
    pad = lambda x: x if Bp is None else np.concatenate(
        [x, np.repeat(x[-1:], Bp - len(x))])
    T = lambda k: torch.tensor(pad(d[k]), dtype=torch.float64)
    return ht.Scenarios(T("p"), T("q"), T("inj"))


def _sharded_cases(s, net, dev, sc, mesh2, hmesh):
    """Every sharded call of the test on its mesh, by case name."""
    sa = s.with_(solver="arrow", layout="lanes")
    out = {
        "sweep2d": par.hpf_sweep_sharded2d(net, dev, sa, sc, mesh2),
        "adaptive": par.hpf_sweep_adaptive_sharded(
            net, dev, sa, sc, mesh2, phase_iters=2, rescue_width=2),
        "continuation": par.hpf_sweep_continuation_sharded(
            net, dev, sa, sc, mesh2, n_stages=3)}
    for solver in ("arrow", "dense"):
        out[f"single_{solver}"] = par.hpf_single_hsharded(
            net, dev, s.with_(solver=solver), hmesh)
    return out


def _unsharded_cases(s, net, dev, d):
    """The unsharded port on the same inputs: the sweeps whose choices
    are global (straggler width, chunks) on the batch padded as the
    2-rank scenario axis pads it."""
    sa = s.with_(solver="arrow", layout="lanes")
    sc, scp = _scenarios(d), _scenarios(d, -(-B // 2) * 2)
    cut = lambda r: par.mesh._tree_map(lambda x: x[:B], r)
    out = {
        "sweep2d": tl.hpf_sweep_lanes(net, dev, sa, sc),
        "adaptive": cut(ht.hpf_sweep_adaptive_lanes(
            net, dev, sa, scp, phase_iters=2, rescue_width=2)),
        "continuation": cut(ht.hpf_sweep_continuation_lanes(
            net, dev, sa, scp, n_stages=3))}
    for solver in ("arrow", "dense"):
        out[f"single_{solver}"] = ht.hpf_single(net, dev,
                                                s.with_(solver=solver))
    return out


def _arrays(results):
    return {f"{case}.{f}": getattr(r, f).numpy()
            for case, r in results.items() for f in FIELDS}


def _rank(rank: int, world: int, store: str, out: str) -> None:
    """One gloo rank: every sharded case, saved to ``out/rank{r}.npz``;
    then a single case on ``harmonic_mesh(2)``, which ranks 2-3 receive
    from outside the mesh."""
    import torch.distributed as dist

    os.nice(10)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "hpfx"))
    assert not bad, f"a rank imported {bad}"
    s, net, dev = _port_setup()
    mesh2 = par.hpf_mesh(2, 2, devices="cpu")
    hmesh = par.harmonic_mesh(4, devices="cpu")
    assert (mesh2.size, mesh2.hsize, hmesh.size, hmesh.hsize) == (2, 2, 1, 4)
    assert hmesh.hbounds(3) == [(0, 1), (1, 2), (2, 3), (3, 3)][rank]
    sc = _scenarios(_inputs())
    res = _sharded_cases(s, net, dev, sc, mesh2, hmesh)
    mesh14 = par.hpf_mesh(1, 4, devices="cpu")
    assert mesh14.hbounds(3) == hmesh.hbounds(3)
    res[EMPTY_RANK] = par.hpf_sweep_sharded2d(
        net, dev, s.with_(solver="arrow", layout="lanes"), sc, mesh14)
    h2 = par.harmonic_mesh(2, devices="cpu")
    res["single_h2"] = par.hpf_single_hsharded(
        net, dev, s.with_(solver="arrow"), h2)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **_arrays(res))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """One spawn of WORLD gloo ranks; their saved results, by rank."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        store = f"file://{os.path.join(tmp, 'store')}"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
             store, tmp], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(WORLD)]


def _jax_setup():
    import hpfx
    s = hpfx.settings_for_hmax(5, coupled=True)
    net = hpfx.load_network(*NET2, s)
    return s, net, hpfx.load_device_set(net, s)


def _jax_cases(d):
    """The JAX package's unsharded functions on the same inputs."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    import hpfx
    from hpfx.lanes import (hpf_sweep_adaptive_lanes,
                            hpf_sweep_continuation_lanes, hpf_sweep_lanes)
    from hpfx.solve import Scenarios

    s, net, dev = _jax_setup()
    sa = s.with_(solver="arrow", layout="lanes")
    Bp = -(-B // 2) * 2
    pad = lambda x: np.concatenate([x, np.repeat(x[-1:], Bp - len(x))])
    sc = Scenarios(*(jnp.asarray(d[k]) for k in ("p", "q", "inj")))
    scp = Scenarios(*(jnp.asarray(pad(d[k])) for k in ("p", "q", "inj")))
    out = {
        "sweep2d": hpf_sweep_lanes(net, dev, settings=sa, scenarios=sc),
        "adaptive": jax.jit(partial(hpf_sweep_adaptive_lanes, settings=sa,
                                    phase_iters=2, rescue_width=2))(
            net, dev, scenarios=scp),
        "continuation": hpf_sweep_continuation_lanes(net, dev, sa, scp,
                                                     n_stages=3)}
    for solver in ("arrow", "dense"):
        out[f"single_{solver}"] = hpfx.hpf_single(
            net, dev, settings=s.with_(solver=solver))
    return {f"{case}.{f}": np.asarray(getattr(r, f))[:B]
            if case in SWEEPS else np.asarray(getattr(r, f))
            for case, r in out.items() for f in FIELDS}


@pytest.fixture(scope="module")
def references():
    """The unsharded port's and the JAX package's results."""
    d = _inputs()
    port = _arrays(_unsharded_cases(*_port_setup(), d))
    refs = port, _jax_cases(d)
    for ref in refs:
        ref.update({f"{EMPTY_RANK}.{f}": ref[f"sweep2d.{f}"] for f in FIELDS})
    return refs


def test_exports_cover_the_reference():
    """hpfx_torch.parallel exports every name of hpfx.parallel."""
    import hpfx.parallel as jpar
    assert not [n for n in jpar.__all__ if n not in par.__all__]
    assert all(hasattr(par, n) for n in par.__all__)


def test_harmonic_split_and_rank_layout():
    """Harmonics split as numpy.array_split splits them (13 over 2 is 7
    and 6, 3 over 4 is 1, 1, 1, 0); hpf_mesh's groups are the columns
    (scenario, strided) and rows (harmonic, consecutive) of JAX's
    ``reshape(n_scenario, n_harmonic)`` of the devices."""
    import jax
    from hpfx.parallel import hpf_mesh as j_hpf_mesh

    for n, k in ((13, 2), (3, 4), (25, 3), (0, 2)):
        pieces = [par.mesh._piece(n, k, i) for i in range(k)]
        split = np.array_split(np.arange(n), k)
        assert [hi - lo for lo, hi in pieces] == [len(a) for a in split]
        assert [lo for lo, _ in pieces] == [int(a[0]) if len(a) else n
                                           for a in split]
    ids = {d: i for i, d in enumerate(jax.devices())}
    for n_s, n_h in ((4, 2), (2, 2), (1, 4), (2, 4), (8, 1)):
        grid = np.vectorize(ids.get)(j_hpf_mesh(n_s, n_h).devices)
        scen, harm = par.mesh._rank_layout(n_s, n_h)
        assert scen == [tuple(grid[:, j]) for j in range(n_h)]
        assert harm == [tuple(grid[i]) for i in range(n_s)]


def test_meshes_alone_are_the_unsharded_calls():
    """No process group: harmonic_mesh() and hpf_mesh(1, 1) are this
    process alone, and the four sharded calls equal the unsharded ones
    bit for bit (no padding, no collective)."""
    for mesh in (par.harmonic_mesh(devices="cpu"),
                 par.hpf_mesh(1, 1, devices="cpu")):
        assert (mesh.size, mesh.hsize, mesh.index, mesh.world) == (1, 1, 0, 1)
        assert mesh.hgroup is None and mesh.hbounds(13) == (0, 13)
    with pytest.raises(ValueError, match="2 x 2 mesh"):
        par.hpf_mesh(2, 2, devices="cpu")
    s, net, dev = _port_setup()
    d = _inputs()
    mesh = par.hpf_mesh(1, 1, devices="cpu")
    got = _arrays(_sharded_cases(s, net, dev, _scenarios(d), mesh, mesh))
    sa = s.with_(solver="arrow", layout="lanes")
    sc = _scenarios(d)
    want = {"sweep2d": tl.hpf_sweep_lanes(net, dev, sa, sc),
            "adaptive": ht.hpf_sweep_adaptive_lanes(
                net, dev, sa, sc, phase_iters=2, rescue_width=2),
            "continuation": ht.hpf_sweep_continuation_lanes(
                net, dev, sa, sc, n_stages=3)}
    for solver in ("arrow", "dense"):
        want[f"single_{solver}"] = ht.hpf_single(net, dev,
                                                 s.with_(solver=solver))
    want = _arrays(want)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _phasor(d, case):
    return d[f"{case}.V_m"] * np.exp(1j * d[f"{case}.V_a"])


def _held(got, want, case, tol, fields=("V_m", "V_a", "err")):
    """Identical counts and flags; ``fields`` within ``tol``, and the
    phasors of the converged scenarios (the JAX package's angles are held
    through them, as test_torch_parallel holds V_m alone: an angle of a
    near-zero harmonic is noise, and the adaptive sweep's unconverged
    lanes stop 2 trips from the cold start, whose transient amplifies the
    two packages' rounding to ~3e-11 pu)."""
    for f in ("n_iter", "converged"):
        np.testing.assert_array_equal(got[f"{case}.{f}"], want[f"{case}.{f}"],
                                      err_msg=f"{case}.{f}")
    for f in fields:
        np.testing.assert_allclose(got[f"{case}.{f}"], want[f"{case}.{f}"],
                                   rtol=0, atol=tol, err_msg=f"{case}.{f}")
    ok = got[f"{case}.converged"]
    np.testing.assert_allclose(_phasor(got, case)[ok],
                               _phasor(want, case)[ok], rtol=0, atol=tol,
                               err_msg=f"{case} phasor")


@pytest.mark.parametrize("case", CASES)
def test_gloo_ranks_hold_the_unsharded_port_and_jax(case, ranks, references):
    """4 gloo ranks on hpf_mesh(2, 2) (the sweeps, B = 9), hpf_mesh(1, 4)
    (the lanes sweep) and harmonic_mesh(4) (the single case), the last
    two with one rank without a harmonic:
    every rank holds the same result; rank 0's equals the unsharded port
    (within SAME_TOL, counts and flags identical) and is within 1e-12 of
    the JAX package's unsharded function.  Phase 1 of the adaptive sweep
    (2 trips) converges no lane, so the global gather rescues K = 2 lanes
    of the whole batch, on both scenario ranks' harmonic groups."""
    port, jax_ref = references
    for r in range(1, WORLD):
        for f in FIELDS:
            np.testing.assert_array_equal(ranks[r][f"{case}.{f}"],
                                          ranks[0][f"{case}.{f}"],
                                          err_msg=f"rank {r} {case}.{f}")
    _held(ranks[0], port, case, SAME_TOL)
    _held(ranks[0], jax_ref, case, TOL, fields=("V_m",))
    conv = ranks[0][f"{case}.converged"]
    if case == "adaptive":
        assert int(conv.sum()) == 2 and not conv[2:].any()
    else:
        assert conv.all()
    if case == "single_arrow":      # ranks 2-3 received it from outside
        for r in range(WORLD):
            for f in FIELDS:
                np.testing.assert_array_equal(
                    ranks[r][f"single_h2.{f}"], ranks[0][f"{case}.{f}"])


@pytest.mark.parametrize("solver", ["arrow", "dense"])
def test_single_case_matches_jax_hsharded(solver, ranks):
    """The port's harmonic-sharded single case (4 gloo ranks) within 1e-10
    of JAX's hpf_single_hsharded over harmonic_mesh(8) on the 8-device CPU
    mesh, with the same iteration count."""
    from hpfx.parallel import harmonic_mesh, hpf_single_hsharded

    s, net, dev = _jax_setup()
    out = hpf_single_hsharded(net, dev, s.with_(solver=solver),
                              harmonic_mesh(8))
    got = ranks[0]
    assert bool(out.converged) and got[f"single_{solver}.converged"]
    assert int(out.n_iter) == int(got[f"single_{solver}.n_iter"])
    for f in ("V_m", "V_a"):
        np.testing.assert_allclose(got[f"single_{solver}.{f}"],
                                   np.asarray(getattr(out, f)), rtol=0,
                                   atol=SINGLE_TOL, err_msg=f)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
