"""The IEEE 33-bus feeder of the port's benchmark (``portbench/data/
ieee33bw``, ``portbench/configs/ieee33bw.json``) on the CPU: its tables
are what ``make.py`` writes, the published feeder's power flow is the
published one, each substation's power electronics draw their share, and
the port's host schedule agrees with the benchmark's float64 reference
(``portbench/reference/hpf_ref.py``) on the split feeder.  Also: the
arrow step's two solves are the module functions that a trace wraps, and
the arrow step and a short sweep come out of the capacitance assembly as
they came out of the former dense one."""
import filecmp
import importlib.util
import json
import os
import sys

import pytest
import torch

import hpfx_torch as ht
from hpfx_torch import fundamental, harmonic, lanes, ybus
from hpfx_torch.devices import load_norton_equivalent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
FEEDER = os.path.join(BENCH, "data", "ieee33bw")
CELL = "ieee33bw.h25-mc512"
sys.path.insert(0, BENCH)

from harness import check  # noqa: E402
from reference import hpf_ref  # noqa: E402
from test_torch_lanes import dense_capacitance_system  # noqa: E402


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


CONFIG = _json("configs", "ieee33bw.json")
LIMIT = _json("workloads", f"{CELL}.json")["limits"]["dv_max_pu"]


def _make():
    spec = importlib.util.spec_from_file_location(
        "ieee33bw_make", os.path.join(FEEDER, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


make = _make()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread, as in every test_torch_* module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(h_max, **kw):
    return ht.settings_for_hmax(h_max, **dict(CONFIG["settings"], **kw))


def test_make_rewrites_the_committed_files(tmp_path):
    names = make.write(str(tmp_path))
    assert len(names) == 2 + 32
    assert sorted(names + ["make.py"]) == sorted(
        f for f in os.listdir(FEEDER) if not f.startswith("__"))
    _, mismatch, errors = filecmp.cmpfiles(str(tmp_path), FEEDER, names,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_the_published_feeder_has_its_published_solution(tmp_path):
    """Baran and Wu's feeder alone, every load PQ: 202.67 kW and 135.14
    kvar of losses, the lowest voltage 0.9131 pu at bus 18 (MATPOWER's
    case33bw)."""
    buses, lines = make.tables(split=False)
    make.write_table(str(tmp_path / "buses.csv"), buses, ";")
    make.write_table(str(tmp_path / "lines.csv"), lines, ";")
    s = _settings(1, dtype="float64")
    net = ht.load_network(str(tmp_path / "buses.csv"),
                          str(tmp_path / "lines.csv"), s, device="cpu")
    Y = ybus.build_ybus(net, s)
    r = fundamental.pf(Y, net, s)
    assert bool(r.converged)
    V = torch.polar(r.V_m, r.V_a)
    S_slack = V[0] * (torch.complex(Y.re[0], Y.im[0]) @ V)[0].conj()
    S_slack = S_slack * s.base_power / 1e3               # kW, kvar
    assert float(net.bus_P.sum()) * s.base_power == pytest.approx(3.715e6)
    assert S_slack.real - 3715.0 == pytest.approx(202.68, abs=0.05)
    assert S_slack.imag - 2300.0 == pytest.approx(135.14, abs=0.05)
    assert float(r.V_m.min()) == pytest.approx(0.9131, abs=1e-4)
    assert int(r.V_m.argmin()) + 1 == 18


@pytest.mark.parametrize("bus", sorted(make.loads()))
def test_each_substation_draws_its_share(bus):
    """At 1 pu and no harmonic voltage, node 100 + b draws 30% of bus b's
    published active power."""
    s = _settings(1, dtype="float64")
    I, Y = load_norton_equivalent(
        os.path.join(FEEDER, f"smps_lv{bus}_NE.csv"), s, coupled=True)
    drawn = (I[0] - Y[0, 0]).real * s.base_power
    P, _ = make.loads()[bus]
    assert drawn == pytest.approx(make.PE_SHARE * P, rel=1e-9)


def _scales(B, seed=11):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((3, B), generator=g, dtype=torch.float64)
    return 0.8 + 0.4 * u[0], 0.8 + 0.4 * u[1], 0.6 + 0.8 * u[2]


def _feeder(h_max, **kw):
    """(settings, network, devices) of the split feeder on the CPU at the
    configuration's settings, ``kw`` over them."""
    s = _settings(h_max, **kw)
    path = lambda f: os.path.join(ROOT, f)
    net = ht.load_network(path(CONFIG["buses"]), path(CONFIG["lines"]), s,
                          device="cpu")
    dev = ht.load_device_set(net, s,
                             search_dirs=(path(CONFIG["device_tables"]),))
    return s, net, dev


@pytest.mark.parametrize("dtype,thresh_h,tol", [
    # float64 stopped far below the rounding of either: the two agree to
    # the reference's own convergence
    ("float64", 1e-9, 1e-8),
    # the configuration's float32 at the port's own stop (thresh_h 1e-4,
    # floor-aware, the step test where the floor lifts it), held to the
    # benchmark cell's limit
    ("float32", None, LIMIT)])
def test_the_host_schedule_is_the_reference(dtype, thresh_h, tol):
    h_max, B = 5, 4
    p, q, sc = _scales(B)
    V_ref, res, it = hpf_ref.solve(check.problem(CONFIG, h_max), p, q, sc)
    assert float(res.max()) < 1e-10 and it < 30
    kw = {"dtype": dtype}
    if thresh_h is not None:
        kw["thresh_h"] = thresh_h
    s, net, dev = _feeder(h_max, **kw)
    rd = s.real_dtype
    r = ht.hpf_sweep_adaptive(
        net, dev, s, ht.Scenarios(p.to(rd), q.to(rd), sc.to(rd)),
        phase_iters=24, phase2_settings=s, warm="cold")
    assert bool(r.converged.all())
    assert float(check.phasor_gap(r.V_m, r.V_a, V_ref).max()) < tol


def test_a_lifted_stop_waits_for_a_short_step():
    """Where the floor lifted the threshold, a mismatch that meets it on a
    trip which moved a phasor by more than ``step_stop`` reads past it,
    so that the lane takes another trip; a short trip, a threshold the
    floor left alone and an infinite one keep the mismatch as it is."""
    s = ht.settings_for_hmax(3)
    assert (s.thresh_h, s.step_stop) == (1e-4, 1e-2)
    thresh = torch.tensor([2e-4, 2e-4, 1e-4, float("inf")])
    lifted = harmonic.lifted_threshold(thresh, s)
    assert lifted.tolist() == [True, True, False, False]
    V_m, V_a = torch.ones((2, 3, 4)), torch.zeros((2, 3, 4))
    Vm_new = V_m.clone()
    Vm_new[1, 2] += torch.tensor([5e-2, 1e-3, 5e-2, 5e-2])
    err = torch.tensor([1.5e-4, 1.5e-4, 5e-5, 1.5e-4])
    got = harmonic.long_step_err(err, thresh, lifted, V_m, V_a, Vm_new, V_a,
                                 (0, 1), s.step_stop)
    assert got[0] == pytest.approx(2e-4 * 5e-2 / 1e-2, rel=1e-5)
    assert got[0] > thresh[0]
    assert torch.equal(got[1:], err[1:])


def test_the_trip_calls_its_two_solves_through_the_module(monkeypatch):
    """One net1 trip runs ``lanes.solve_arrow_blocks_lanes`` and
    ``lanes.solve_capacitance_lanes`` as looked up in the module, so that
    wrapping them (as the benchmark's traced runs do) sees both solves and
    changes no bit of the result."""
    data = os.path.join(ROOT, "hpfx", "data")
    s = ht.settings_for_hmax(9, coupled=True, dtype="float32",
                             solver="arrow", stable_mismatch=True,
                             big_solve="panel", max_iter_h=1)
    net = ht.load_network(os.path.join(data, "net1_buses.csv"),
                          os.path.join(data, "net1_lines.csv"), s,
                          device="cpu")
    dev = ht.load_device_set(net, s)
    p, q, sc = (x.float() for x in _scales(2))
    run = lambda: lanes.hpf_sweep_lanes(net, dev, s, ht.Scenarios(p, q, sc))
    plain = run()
    calls = {}

    def counting(name):
        fn = getattr(lanes, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(lanes, name, wrapped)

    counting("solve_arrow_blocks_lanes")
    counting("solve_capacitance_lanes")
    seen = run()
    assert calls == {"solve_arrow_blocks_lanes": 1,
                     "solve_capacitance_lanes": 1}
    assert int(seen.n_iter.max()) == 1
    for a, b in ((plain.V_m, seen.V_m), (plain.V_a, seen.V_a),
                 (plain.err, seen.err)):
        assert torch.equal(a, b)


def _scenarios(B, s):
    return ht.Scenarios(*(x.to(s.real_dtype) for x in _scales(B)))


def _arrow_steps(h_max, dtype, B, monkeypatch):
    """One arrow step of the feeder on B lanes from the exact-linear seed,
    with the d = d' capacitance assembly and with the former dense one."""
    s, net, dev = _feeder(h_max, dtype=dtype)
    su = lanes._sweep_setup(net, dev, s, _scenarios(B, s))
    V_m, V_a = lanes._linear_seed_lanes(su, net, s)
    f, _ = lanes.mismatch_lanes(V_m, V_a, su.Y, su.S, su.dev, su.inj_db,
                                net.m, net.n, net.c, su.lineY)
    step = lambda: lanes.arrow_step_lanes(V_m, V_a, f, su.Y, su.dev,
                                          su.inj_db, su.consts,
                                          big_solve=s.big_solve)
    dx = step()
    with monkeypatch.context() as mp:
        mp.setattr(lanes, "_capacitance_system_lanes",
                   dense_capacitance_system)
        return dx, step()


def test_the_arrow_step_is_the_dense_assemblys(monkeypatch):
    """One arrow step of the feeder at H<=25 (832 capacitance rows) on 3
    lanes gives the dx of the former dense capacitance assembly: to 1e-6
    of its scale in float64.  In float32 the solve of the 832-row system
    magnifies the rounding of the two assemblies' sums (the d = d' one
    adds the same terms in another order) to ~2e-6 of the scale, against
    ~1.5e-3 between either float32 step and the float64 one: there the
    two agree to 1e-5 of the scale and lie as far from float64 within 1%."""
    dx, dx_ref = _arrow_steps(25, "float64", 3, monkeypatch)
    scale = float(dx_ref.abs().max())
    assert float((dx - dx_ref).abs().max()) <= 1e-6 * scale
    dx32, dx32_ref = _arrow_steps(25, "float32", 3, monkeypatch)
    assert float((dx32 - dx32_ref).abs().max()) <= 1e-5 * scale
    err = lambda d: float((d.double() - dx).abs().max())
    assert err(dx32) <= 1.01 * err(dx32_ref)


def test_a_short_sweep_keeps_its_newton_trips(monkeypatch):
    """The feeder's device sweep at H<=9 on 8 lanes from the exact-linear
    seed, in the configuration's float32: the Newton trips and converged
    flags of the former dense capacitance assembly, and its voltages to
    1e-5 pu and rad.  (From the cold start the feeder's Newton transient
    runs 15-28 trips and parts on rounding alone, float64 too.)"""
    s, net, dev = _feeder(9, dtype="float32")
    run = lambda: ht.hpf_sweep_device(net, dev, s, _scenarios(8, s),
                                      phase_iters=24, warm="linear")
    got = run()
    monkeypatch.setattr(lanes, "_capacitance_system_lanes",
                        dense_capacitance_system)
    ref = run()
    assert bool(ref.converged.all())
    assert torch.equal(got.n_iter, ref.n_iter)
    assert torch.equal(got.converged, ref.converged)
    assert float((got.V_m - ref.V_m).abs().max()) <= 1e-5
    assert float((got.V_a - ref.V_a).abs().max()) <= 1e-5
