"""Entry points of the port, the twin of the repository's
``__graft_entry__.py``: a single-card step and a multi-rank dry run.

    python -c "from hpfx_torch.entry import entry; fn, a = entry(); fn(*a)"
    python -c "from hpfx_torch.entry import dryrun_multichip as d; d(2)"

:func:`dryrun_multichip` starts its ranks as processes of
``python -m hpfx_torch.entry RANK WORLD STORE [OUT]``.
"""
from __future__ import annotations

import collections
import datetime
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import hpfx_torch as ht
from hpfx_torch import parallel as par
from hpfx_torch._device import resolve_device
from hpfx_torch.utils.profiling import OUTSIDE

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DATA = os.path.join(_REPO, "hpfx", "data")
#: seconds a dry-run rank may take, and a collective may wait: a hung
#: collective fails within GROUP_TIMEOUT_S; beside a loaded test suite on
#: 8 cores a niced rank runs at about a tenth of a core, and the 2-rank
#: test (its ranks and its JAX references) took 230 s (32 s alone)
RANK_TIMEOUT_S = 600
GROUP_TIMEOUT_S = 120
#: the device library of the dry run's device-mix batch
LIBRARY = ("SMPS", "ev_1")
#: float64 sharded against unsharded: the same arithmetic on every lane;
#: a CPU's vector and scalar loops may still round a lane differently
SAME_TOL = 1e-12


def _setup(h_max=25, coupled=True, device=None):
    """net2 with its devices; float32 on the card, float64 on the CPU."""
    dv = resolve_device(device)
    dtype = "float64" if dv.type == "cpu" else "float32"
    s = ht.settings_for_hmax(h_max, coupled=coupled, dtype=dtype)
    net = ht.load_network(os.path.join(_DATA, "net2_buses.csv"),
                          os.path.join(_DATA, "net2_lines.csv"), s,
                          device=dv)
    return s, net, ht.load_device_set(net, s)


def entry(device=None):
    """The flagship step: a batched coupled harmonic power flow, net2
    H<=25, B=64.  Returns ``(fn, example_args)`` such that
    ``fn(*example_args)`` runs :func:`hpfx_torch.solve.hpf_sweep` on
    ``device`` (default: the CUDA card)."""
    s, net, dev = _setup(device=device)
    B = 64
    lin = lambda a, b: torch.linspace(a, b, B, dtype=s.real_dtype,
                                      device=net.device)
    scen = ht.Scenarios(p_scale=lin(0.9, 1.1), q_scale=lin(0.9, 1.1),
                        injection_scale=lin(0.8, 1.2))

    def fn(net_, dev_, scen_):
        return ht.hpf_sweep(net_, dev_, s, scen_)

    return fn, (net, dev, scen)


def dryrun_multichip(n_devices: int, out=None) -> None:
    """Run the sharded sweeps over ``n_devices`` gloo ranks on the CPU
    (processes of this module), each check of ``__graft_entry__``'s 1-D
    mesh and, when ``n_devices`` is even, its 2-D scenario x harmonic
    block (:func:`hpfx_torch.parallel.hpf_sweep_sharded2d` on
    ``hpf_mesh(n_devices // 2, 2)``); raises if a rank fails and prints
    rank 0's report.  ``out``: a directory where each rank saves its
    scenarios and its copy of every sharded result as ``rank{r}.npz``."""
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{os.path.join(tmp, 'store')}"
        env = dict(os.environ, OMP_NUM_THREADS="1")
        argv = [str(n_devices), store] + ([] if out is None else [str(out)])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "hpfx_torch.entry", str(r)] + argv,
            cwd=_REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {r} "
                               f"exited {p.returncode}:\n{log[-4000:]}")
    print(logs[0], end="")


def _gap(a, b) -> float:
    """max |a - b|, NaN padding equal to itself."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    return float((a - b).abs().nan_to_num(float("inf")).max())


def _check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def _rank_main(rank: int, world: int, store: str, out=None) -> None:
    """One rank of :func:`dryrun_multichip`.  Every rank runs the sharded
    calls; rank 0 reports, and holds each result to the unsharded call on
    the same padded batch within ``SAME_TOL`` (the gap is printed): every
    lane is solved by the same arithmetic, and the global steps
    (aggregate, straggler gather, continuation chunks) make the same
    choices."""
    import torch.distributed as dist

    # the ranks yield the cores to whatever runs beside the dry run, such
    # as a test suite's other workers, whose tests may time themselves
    os.nice(10)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S))
    ref = rank == 0
    say = print if ref else (lambda *a: None)
    s, net, dev = _setup(h_max=5, device="cpu")
    sa = s.with_(solver="arrow", layout="lanes")
    rd = s.real_dtype
    mesh = par.scenario_mesh(devices="cpu")
    pad = lambda sc: par.mesh._pad_scenarios(sc, mesh)[0]
    cut = lambda r, k: par.mesh._tree_map(lambda x: x[:k], r)

    # deliberately not mesh-divisible: the pad + mask path; the injection
    # spread wide enough that worst-bus THD straddles the limit
    B = 2 * world + 1
    Bp = -(-B // world) * world
    n_nl = net.n_nonlinear
    rng = np.random.default_rng(12)
    inp = dict(p=np.linspace(0.9, 1.1, B), q=np.linspace(0.9, 1.1, B),
               inj=np.linspace(0.3, 1.5, B),
               inj_nl=rng.uniform(0.6, 1.2, (B, n_nl)),
               mix=rng.uniform(0.0, 1.0, (B, n_nl, len(LIBRARY))))
    T = lambda k: torch.tensor(inp[k], dtype=rd)
    scen = ht.Scenarios(T("p"), T("q"), T("inj"))
    saved = {}

    def held(tag, name, got, want, *, all_conv=True, batch=B):
        """Save ``got`` under keys prefixed ``tag``; on rank 0 hold it to
        ``want()`` (the unsharded call, made only there): equal flags and
        counts, voltages within SAME_TOL.  Returns the voltage gap."""
        saved.update({f"{tag}V": got.V_m, f"{tag}conv": got.converged,
                      f"{tag}it": got.n_iter})
        _check(got.V_m.shape[0] == batch,
               f"{name}: batch {got.V_m.shape[0]}")
        _check(not all_conv or bool(got.converged.all()),
               f"sharded {name} failed to converge")
        if not ref:
            return 0.0
        want = want()
        dv = _gap(got.V_m, want.V_m)
        _check(dv <= SAME_TOL
               and bool((got.converged == want.converged).all())
               and bool((got.n_iter == want.n_iter).all()),
               f"sharded {name} deviates from unsharded: {dv}")
        return dv

    res = par.hpf_sweep_sharded(net, dev, s, scen, mesh)
    dv = held("", "sweep", res, lambda: ht.hpf_sweep(net, dev, s, scen))

    thd_limit = 0.33
    summary = par.hosting_capacity_sharded(net, dev, s, scen, mesh,
                                           thd_limit=thd_limit)
    frac = float(summary.frac_over_limit)
    expect = float(np.mean((summary.max_thd_f.numpy() > thd_limit)
                           & summary.converged.numpy()))
    _check(0.0 < frac < 1.0, f"non-discriminating aggregate: {frac}")
    _check(abs(frac - expect) < 1e-12, f"{frac} != {expect}")
    saved.update(hthd=summary.max_thd_f, hconv=summary.converged,
                 frac=summary.frac_over_limit)
    say(f"dryrun_multichip({world}): converged batch of {B} (padded to "
        f"mesh multiple) == unsharded to {dv:.1e}, frac_over_limit="
        f"{frac:.3f} == host recomputation {expect:.3f}")

    # device-mix Monte-Carlo: (B, n_nl) scales + DeviceLibrary blends
    lib = ht.load_device_library(LIBRARY, s, device="cpu")
    ones = torch.ones(B, dtype=rd)
    scen_m = ht.Scenarios(ones, ones, T("inj_nl"), T("mix"))
    dvm = held("m", "device-mix sweep", par.hpf_sweep_sharded(net, lib, s, scen_m, mesh),
               lambda: ht.hpf_sweep(net, lib, s, scen_m))
    say(f"dryrun_multichip: device-mix sweep (B={B}, {n_nl} buses x "
        f"{len(LIBRARY)} types) sharded == unsharded to {dvm:.1e}")

    # the device continuation: its key sort, chunk seeds and rescue are
    # global, so it is held to the unsharded program on the padded batch
    dvc = held("c", "continuation sweep", par.hpf_sweep_continuation_sharded(
        net, dev, sa, scen, mesh, n_stages=3), lambda: cut(
        ht.hpf_sweep_continuation_lanes(net, dev, sa, pad(scen),
                                        n_stages=3), B))
    say(f"dryrun_multichip: continuation sweep (B={B}, 3 stages) sharded "
        f"== unsharded to {dvc:.1e}")

    # phase 1's 2 trips converge no lane, so stragglers lie on every
    # rank: the global gather rescues the K = 2 lanes of the whole batch,
    # where a per-rank gather would rescue 2 on each rank; the bucketed
    # width covers every straggler.  Each rank keeps a PhaseLog and traces
    # its spans: one hpfx.trip per harmonic trip it counted, and one
    # hpfx.gather per collective (the straggler masks, then the result's
    # leaves), the same number on every rank
    for tag, name, kw in (
            ("a", "adaptive", dict(rescue_width=2)),
            ("w", "warm-seeded adaptive",
             dict(warm="linear", rescue_width=(2, Bp)))):
        log = ht.PhaseLog()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ra = par.hpf_sweep_adaptive_sharded(net, dev, sa, scen, mesh,
                                                phase_iters=2, log=log,
                                                **kw)
        spans = collections.Counter(e.name for e in prof.events())
        trips = sum(log.harmonic_trips.values())
        _check(spans["hpfx.sweep"] == 1 and log.trips["phase1"] > 0
               and spans["hpfx.trip"] == trips > 0,
               f"sharded {name}: {spans['hpfx.trip']} trip spans, "
               f"{trips} trips logged")
        saved[f"{tag}gathers"] = torch.tensor(spans["hpfx.gather"])
        dva = held(tag, f"{name} sweep", ra, lambda: cut(ht.hpf_sweep_adaptive_lanes(
            net, dev, sa, pad(scen), phase_iters=2, **kw), B),
            all_conv=tag == "w")
        n_conv = int(ra.converged.sum())
        _check(tag == "w" or n_conv == 2,
               f"sharded {name}: {n_conv} lanes rescued, not 2")
        say(f"dryrun_multichip: {name} sweep (B={B}, phase 2, rescue "
            f"width {kw['rescue_width']}: {n_conv} converged) sharded == "
            f"unsharded to {dva:.1e}; PhaseLog {trips} harmonic trips "
            f"(rank 0), {spans['hpfx.gather']} hpfx.gather spans")

    if world % 2 == 0:
        # 2-D scenario x harmonic mesh (DP x TP): each scenario piece's
        # Newton trip split over a harmonic group of two ranks; a batch
        # that does not divide the mesh
        B2 = world + 3
        inp.update(p2=np.linspace(0.97, 1.03, B2),
                   q2=np.linspace(0.98, 1.02, B2),
                   inj2=np.linspace(0.9, 1.1, B2))
        scen2 = ht.Scenarios(T("p2"), T("q2"), T("inj2"))
        mesh2 = par.hpf_mesh(world // 2, 2, devices="cpu")
        log2 = ht.PhaseLog()
        r2 = par.hpf_sweep_sharded2d(net, dev, sa, scen2, mesh2, log=log2)
        _check(log2.reads[OUTSIDE] >= 2,
               f"2-D sharded sweep: reads {log2.reads}")
        dv2 = held("2", "2-D sharded sweep", r2,
                   lambda: ht.hpf_sweep(net, dev, sa, scen2), batch=B2)
        say(f"dryrun_multichip: 2-D ({world // 2}, 2) scenario x harmonic "
            f"mesh, B={B2}, converged; == unsharded to {dv2:.1e}")

    if world > 2:
        # the first two ranks take the scenarios; the others still get all
        sub = par.scenario_mesh(2, devices="cpu")
        _check(sub.size == 2 and (sub.index is None) == (rank >= 2),
               "a mesh of the first two ranks")
        rsub = par.hpf_sweep_sharded(net, dev, s, scen, sub)
        _check(torch.equal(rsub.V_m, res.V_m),
               "a mesh of two ranks deviates from the whole mesh")
        saved["subV"] = rsub.V_m
        say(f"dryrun_multichip: a mesh of ranks 0-1 == the mesh of "
            f"{world}; rank {world - 1} received the result")

    # batched IFT sensitivities and the IEEE-519 screen on the shards of a
    # mesh-divisible slice of the sweep, joined by collectives
    Bs = 2 * world
    res_s = cut(res, Bs)
    scen_s = ht.Scenarios(*(None if x is None else x[:Bs] for x in scen))
    lo, hi = mesh.bounds(Bs)
    res_k = par.mesh._tree_map(lambda x: x[lo:hi], res_s)
    scen_k = par.shard_scenarios(scen_s, mesh)
    grad = [mesh.all_gather(a, Bs) for a in
            ht.sweep_sensitivity(net, dev, s, res_k, scen_k).grad]
    scr = ht.ieee519_screen(res_k, s)
    viol = ((~scr.compliant) & res_k.converged).to(rd).sum()
    n_conv = res_k.converged.to(rd).sum()
    for x in (viol, n_conv):
        dist.all_reduce(x, group=mesh.group)
    frac519 = float(viol / torch.clamp_min(n_conv, 1.0))
    compliant = mesh.all_gather(scr.compliant, Bs)
    if ref:
        dg = max(_gap(a, b) for a, b in zip(grad, ht.sweep_sensitivity(
            net, dev, s, res_s, scen_s).grad))
        _check(dg <= SAME_TOL, f"sharded sweep_sensitivity deviates: {dg}")
        say(f"dryrun_multichip: sweep_sensitivity (B={Bs}) sharded == "
            f"unsharded to {dg:.1e}")
        ref519 = ht.ieee519_screen(res_s, s)
        _check(bool((compliant == ref519.compliant).all()),
               "ieee519_screen differs")
        _check(frac519 == float(ref519.frac_violating),
               f"frac_violating {frac519} != "
               f"{float(ref519.frac_violating)}")
        say(f"dryrun_multichip: ieee519_screen (B={Bs}) sharded == "
            f"unsharded, frac_violating={frac519:.3f}")
    if out is not None:
        np.savez(os.path.join(out, f"rank{rank}.npz"), **inp,
                 **{k: v.numpy() for k, v in saved.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
               *sys.argv[4:5])
