"""The port's tracer on the CPU: the ``hpfx.*`` spans a sweep opens under
``torch.profiler`` (``hpfx_torch.utils.profiling.span``) and the counts
of :class:`hpfx_torch.PhaseLog`, on the two entries the benchmark drives
(net2's ``hpf_sweep_device`` and net1's ``hpf_sweep_adaptive``) in
float64 at small sizes.

A span nests by time on one thread: a trip's stages lie inside its
``hpfx.trip``.  Tracing must not change a result, and with no profiler
recording the sweep enters no ``record_function`` at all."""
import collections
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hpfx_torch as ht
from hpfx_torch import lanes
from hpfx_torch.utils.profiling import OUTSIDE
from test_torch_foundations import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "hpfx", "data")
STAGES = ("mismatch", "blocks", "block_solve", "capacitance", "backsub",
          "update", "read")
B = 6


def _case(name, dtype="float64", **settings):
    """(call(log=None) -> result, settings) of one cell's entry at a small
    size: net2 H<=5 on the device schedule from the linear seed, net1 H<=7
    on the host schedule from the cold start."""
    h = 5 if name == "net2" else 7
    s = ht.settings_for_hmax(h, coupled=True, dtype=dtype).with_(
        solver="arrow", stable_mismatch=True, big_solve="panel",
        layout="lanes", **settings)
    net = ht.load_network(os.path.join(DATA, f"{name}_buses.csv"),
                          os.path.join(DATA, f"{name}_lines.csv"), s,
                          device="cpu")
    dev = ht.load_device_set(net, s)
    t = lambda a, b: torch.linspace(a, b, B, dtype=s.real_dtype)
    sc = ht.Scenarios(t(0.8, 1.2), t(1.2, 0.8), t(0.6, 1.4))
    if name == "net2":
        return lambda log=None: ht.hpf_sweep_device(
            net, dev, s, sc, phase_iters=3, warm="linear", log=log)
    return lambda log=None: ht.hpf_sweep_adaptive(
        net, dev, s, sc, phase_iters=3, phase2_settings=s, warm="cold",
        log=log)


def _spans(fn):
    """Run ``fn`` under a CPU profiler: its result and the ``hpfx.*``
    spans as (name, start, end), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("hpfx.")),
                   key=lambda x: x[1])
    return out, spans


def _inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


def _leaves(res):
    out = [x for x in res[:6]]
    out += [x for x in res.fund] if res.fund is not None else []
    return out


@pytest.fixture(scope="module", params=["net2", "net1"])
def traced(request):
    """Each entry run plain, with a log, and with a log under the
    profiler: (name, plain result, log, traced result, spans)."""
    call = _case(request.param)
    plain = call()
    log = ht.PhaseLog()
    res, spans = _spans(lambda: call(log))
    return request.param, plain, log, res, spans


def test_one_trip_span_per_counted_trip(traced):
    """One ``hpfx.trip`` per harmonic trip the log counted and one
    ``hpfx.fund_trip`` per fundamental one, each of the seven stages once
    inside every trip, and one ``hpfx.phase.<name>`` span per phase
    entered, all inside the one ``hpfx.sweep``."""
    _, _, log, _, spans = traced
    by = collections.defaultdict(list)
    for sp in spans:
        by[sp[0]].append(sp)
    n_h = sum(log.harmonic_trips.values())
    assert n_h > 0 and len(by["hpfx.trip"]) == n_h
    assert len(by["hpfx.fund_trip"]) == sum(log.trips.values()) - n_h > 0
    for stage in STAGES:
        got = by[f"hpfx.trip.{stage}"]
        assert len(got) == n_h, stage
        for sp, trip in zip(got, by["hpfx.trip"]):
            assert _inside(sp, trip), stage
    assert {f"hpfx.phase.{p}" for p in log.seconds} == \
        {n for n in by if n.startswith("hpfx.phase.")}
    (sweep,) = by["hpfx.sweep"]
    assert all(_inside(sp, sweep) for sp in spans)
    # at least the block solve and the capacitance solve in each trip
    assert len(by["hpfx.solve"]) >= 2 * n_h


def test_the_assembly_span_lies_inside_the_capacitance_span(traced):
    """One ``hpfx.trip.assemble`` a trip, inside its trip's
    ``hpfx.trip.capacitance`` and before the capacitance solve's
    ``hpfx.solve`` there."""
    _, _, log, _, spans = traced
    by = collections.defaultdict(list)
    for sp in spans:
        by[sp[0]].append(sp)
    got = by["hpfx.trip.assemble"]
    assert len(got) == sum(log.harmonic_trips.values()) > 0
    for sp, cap in zip(got, by["hpfx.trip.capacitance"]):
        assert _inside(sp, cap)
        solves = [x for x in by["hpfx.solve"] if _inside(x, cap)]
        assert solves and all(sp[2] <= x[1] for x in solves)


def test_tracing_changes_no_result(traced):
    """The sweep with a log under the profiler returns the plain sweep's
    result bit for bit (NaN-padded histories equal themselves)."""
    _, plain, _, res, _ = traced
    for a, b in zip(_leaves(plain), _leaves(res)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_reads_count_every_trip_and_the_loops_first_test(traced):
    """Each Newton loop reads its convergence test once before its first
    trip and once after each, so a phase that runs loops reads at least
    its trips plus one; the straggler and bucket reads add to that."""
    name, _, log, _, _ = traced
    for phase, trips in log.trips.items():
        if trips:
            assert log.reads[phase] >= trips + 1, phase
    assert sum(log.reads.values()) > sum(log.trips.values())
    if name == "net2":
        # the device schedule's straggler choice and its rescue test
        assert log.reads[OUTSIDE] >= 2


def test_harmonic_trips_are_the_loops_trips(monkeypatch):
    """``harmonic_trips`` sums to the trips of every ``nr_trip_lanes``
    loop of the call (the most trips a lane took, as the loop runs while
    one is active), and their seconds to no more than the phases'."""
    loops = []
    inner = lanes.nr_trip_lanes

    def counted(*a, **k):
        out = inner(*a, **k)
        loops.append(int(out[3].max()) if out[3].numel() else 0)
        return out

    monkeypatch.setattr(lanes, "nr_trip_lanes", counted)
    for name in ("net2", "net1"):
        loops.clear()
        log = ht.PhaseLog()
        _case(name)(log)
        assert sum(log.harmonic_trips.values()) == sum(loops) > 0, name
        for phase, n in log.harmonic_trips.items():
            assert 0.0 <= log.harmonic_trip_seconds[phase] \
                <= log.seconds[phase]
            assert (n > 0) == (log.harmonic_trip_seconds[phase] > 0)


@pytest.mark.parametrize("name", ["net2", "net1"])
def test_no_profiler_enters_no_span(name, monkeypatch):
    """With no profiler recording and no log, the sweep never enters a
    ``record_function``: the span helper returns before it."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    res = _case(name)()
    assert res.converged.any()


@pytest.mark.parametrize("name", ["net2", "net1"])
def test_phase_spans_without_a_log(name):
    """The phases' spans are the program's own: a sweep with no log opens
    them too, and its trips' spans."""
    _, spans = _spans(_case(name))
    names = {sp[0] for sp in spans}
    assert {"hpfx.sweep", "hpfx.phase.phase1", "hpfx.trip",
            "hpfx.fund_trip", "hpfx.solve"} <= names
    if name == "net2":
        assert {"hpfx.phase.setup", "hpfx.phase.seed",
                "hpfx.phase.cold_restart"} <= names


def test_rescue_passes_are_phases_inside_the_rescue():
    """Two trips of budget leave every lane to the host rescue in float32:
    its self-warm, cold and float64 passes run as phases inside
    "host_rescue", which holds their time and counts no trip of its own;
    every trip is still counted once."""
    log = ht.PhaseLog()
    res, spans = _spans(lambda: _case(
        "net2", dtype="float32", max_iter_h=2)(log))
    assert not bool(res.converged.all())
    passes = ("rescue_self", "rescue_cold", "rescue_float64")
    assert set(passes) <= set(log.seconds)
    assert log.seconds["host_rescue"] >= sum(log.seconds[p]
                                             for p in passes)
    assert log.trips["host_rescue"] == 0
    assert all(log.harmonic_trips[p] > 0 for p in passes)
    assert sum(log.trips.values()) == sum(
        1 for sp in spans if sp[0] in ("hpfx.trip", "hpfx.fund_trip"))
    (rescue,) = [sp for sp in spans if sp[0] == "hpfx.phase.host_rescue"]
    for p in passes:
        (sp,) = [x for x in spans if x[0] == f"hpfx.phase.{p}"]
        assert _inside(sp, rescue), p
