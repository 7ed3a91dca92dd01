"""The metric arithmetic on synthetic records."""
import math

import pytest

from harness import roofline, spec, stats, trace


def test_union_of_intervals():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)], 8, 25) == 12
    assert trace.busy_us([]) == 0


def test_gaps_are_what_the_union_leaves():
    ivs = [(2, 4), (3, 6), (9, 10)]
    assert trace.gaps(ivs, 0, 12) == [(0, 2), (6, 9), (10, 12)]
    assert sum(e - s for s, e in trace.gaps(ivs, 0, 12)) \
        == 12 - trace.busy_us(ivs, 0, 12)


def _events():
    """Two spans; kernels launched inside and outside them; a ctypes
    launch (no operator) inside the second."""
    ua = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",
                                "name": name, "ts": ts, "dur": dur, "tid": 1}
    rt = lambda ts, corr: {"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                           "tid": 1, "args": {"correlation": corr}}
    k = lambda name, ts, dur, corr: {"ph": "X", "cat": "kernel",
                                     "name": name, "ts": ts, "dur": dur,
                                     "args": {"correlation": corr}}
    return [ua("batched_solve_lanes", 0, 10), ua("panel_gj_solve_lanes", 2, 5),
            ua("batched_solve_lanes", 30, 10),
            rt(1, 1), rt(3, 2), rt(20, 3), rt(35, 4),
            k("a", 5, 4, 1), k("gj_panel_kernel<32>(x)", 9, 3, 2),
            k("b", 22, 6, 3), k("gj_kernel<1, 32>(y)", 40, 2, 4),
            {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 12,
             "dur": 6, "tid": 1}]


def test_device_time_under_spans():
    out = trace.under_spans(_events(), ["batched_solve_lanes",
                                        "panel_gj_solve_lanes"])
    assert out["batched_solve_lanes"] == 4 + 3 + 2
    assert out["panel_gj_solve_lanes"] == 3
    assert out["*"] == 9          # each record once


def test_idle_gaps_named_by_the_host():
    ev = _events()
    recs = [(s, e) for _, s, e in trace.device_records(ev)]
    labels = trace.label_gaps(ev, trace.gaps(recs, 0, 42), 1)
    assert labels["aten::nonzero"] == 22 - 12
    assert sum(labels.values()) == 42 - trace.busy_us(recs, 0, 42)


def test_kernel_time_by_template_name():
    by = {"void gj_kernel<1, 32>(...)": 5.0, "gj_kernel_carried<64>(..)": 7.0}
    assert trace.kernel_us(by, "gj_kernel") == 5.0
    assert trace.kernel_us(by, "gj_kernel_carried") == 7.0


def test_roofline_sums_each_shape():
    n, R, B = 40, 15, 26624
    nbytes, flops = roofline.solve_work(n, R, B)
    assert nbytes == 4 * B * (n * n + 2 * n * R)
    assert flops == B * (2 * n ** 3 / 3 + 2 * n * n * R)
    one = max(nbytes / roofline.PEAK_BYTES, flops / roofline.PEAK_FLOPS)
    launches = {(n, R, B): 3, (26, 1, 1024): 2}
    want = 3 * one + 2 * roofline.bound(*roofline.solve_work(26, 1, 1024))[0]
    assert roofline.bound_seconds("gj_kernel", launches) == pytest.approx(want)
    assert roofline.bound(*roofline.panel_work(192, 32, 2048))[1] == "bytes"


def test_p90_of_all_calls_and_rate_over_the_window():
    times = [float(i) for i in range(1, 101)]
    assert stats.p90(times) == pytest.approx(90.9)
    assert stats.rate(1000, 4.0) == 250.0


def _record():
    return {"cell": "x", "batch": 4, "calls": [0.5, 0.5, 1.0],
            "converged": [4, 4, 3], "window_s": 2.2, "setup_s": 9.0,
            "phases": {"seconds": {"phase1": 0.6, "host_rescue": 0.2,
                                   "cold_restart": 0.8,
                                   "rescue_phase2": 0.2},
                       "trips": {"phase1": 6, "cold_restart": 12}},
            "device": {"busy_us": 1.5e6, "wall_us": 2e6, "records": 3,
                       "by_name": {"gj_kernel<1, 32>(a)": 1e3,
                                   "gj_panel_kernel<32>(b)": 2e3},
                       "launches": {("gj_kernel", (40, 15, 26624)): 2,
                                    ("gj_panel_kernel", (192, 32, 2048)): 4}},
            "spans": {"busy_us": 100.0, "wall_us": 150.0,
                      "under": {"*": 40.0}, "idle_by_host": {}}}


def test_readers_on_a_record():
    rec = _record()
    read = lambda n: spec.metric_reader(n)(rec)
    assert read("solves_per_s") == pytest.approx(11 / 2.2)
    assert read("setup_s") == 9.0
    assert read("solve.host_rescue_share") == pytest.approx(0.1)
    assert read("lanes.restart_share") == pytest.approx(0.5)
    assert read("lanes.trips_per_sweep") == pytest.approx(6)
    assert read("trip.phase1_trip_ms") == pytest.approx(100.0)
    assert read("ops.solve_share") == pytest.approx(0.4)
    assert read("device.idle_share") == pytest.approx(0.25)
    k1 = 200 * roofline.bound(*roofline.solve_work(40, 15, 26624))[0] / 1e-3
    assert read("k1_roofline") == pytest.approx(k1)
    k4 = 400 * roofline.bound(*roofline.panel_work(192, 32, 2048))[0] / 2e-3
    assert read("k4_roofline") == pytest.approx(k4)


def test_readers_that_find_nothing_return_nothing():
    rec = dict(_record(), phases=None, device=None, spans=None)
    for name in ("solve.host_rescue_share", "lanes.restart_share",
                 "lanes.trips_per_sweep", "trip.phase1_trip_ms",
                 "ops.solve_share", "device.idle_share", "k1_roofline",
                 "k4_roofline"):
        assert spec.metric_reader(name)(rec) is None, name
    rec = _record()
    rec["device"] = dict(rec["device"], launches={}, by_name={})
    assert spec.metric_reader("k1_roofline")(rec) is None
    assert not math.isnan(spec.metric_reader("device.idle_share")(rec))
