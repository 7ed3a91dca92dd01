"""The program's spans in a synthetic trace (``harness.program``) and the
readers of what the program counts itself."""
import pytest

from harness import program, spec


def _events():
    """A sweep span around two trips, each with a solve span inside (the
    second trip's solve nested in a stage); kernels launched inside and
    outside the spans, one by a ctypes launch that no operator encloses,
    one whose runtime call the trace lost; device idle in between."""
    ua = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation",
                                "name": name, "ts": ts, "dur": dur, "tid": 1}
    rt = lambda ts, corr: {"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                           "tid": 1, "args": {"correlation": corr}}
    k = lambda ts, dur, corr: {"ph": "X", "cat": "kernel", "name": "k",
                               "ts": ts, "dur": dur,
                               "args": {"correlation": corr}}
    return [ua("hpfx.sweep", 0, 100),
            ua("hpfx.trip", 10, 30), ua("hpfx.solve", 12, 8),
            ua("hpfx.trip", 50, 40), ua("hpfx.trip.capacitance", 55, 20),
            ua("hpfx.solve", 60, 10),
            ua("other", 0, 100),
            rt(5, 1), rt(14, 2), rt(30, 3), rt(62, 4), rt(95, 5),
            k(6, 4, 1), k(20, 10, 2), k(35, 10, 3), k(70, 15, 4),
            k(96, 2, 5), k(98, 1, 6),
            {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 46,
             "dur": 2, "args": {"correlation": 3}}]


def test_program_spans_count_wall_records_and_idle():
    out = program.program(_events(), 0, 100)
    assert set(out) == {"hpfx.sweep", "hpfx.trip", "hpfx.solve",
                        "hpfx.trip.capacitance"}
    trip = out["hpfx.trip"]
    assert trip["n"] == 2 and trip["wall_us"] == 70
    # launches at 14 and 30 (the kernel and the copy of correlation 3)
    # in the first trip, at 62 in the second
    assert trip["records"] == 4 and trip["device_us"] == 10 + 10 + 2 + 15
    solve = out["hpfx.solve"]
    assert solve["n"] == 2 and solve["records"] == 2
    assert solve["device_us"] == 10 + 15
    # the kernel without its runtime call belongs to no span
    assert out["hpfx.sweep"]["records"] == 6
    # idle gaps: [0, 6), [10, 20), [30, 35), [45, 46), [48, 70), [85, 96),
    # [99, 100); their middles 3, 15, 32.5, 45.5, 59, 90.5, 99.5
    assert out["hpfx.sweep"]["idle_us"] == 6 + 10 + 5 + 1 + 22 + 11 + 1
    assert trip["idle_us"] == 10 + 5 + 22
    assert solve["idle_us"] == 10
    # nested at any depth: the second trip's solve lies in a stage
    assert out["hpfx.trip.capacitance"]["idle_us"] == 22


def test_nested_spans_of_one_name_count_once():
    ev = _events() + [{"ph": "X", "cat": "user_annotation",
                       "name": "hpfx.trip", "ts": 12, "dur": 4, "tid": 1}]
    out = program.program(ev, 0, 100)
    assert out["hpfx.trip"]["n"] == 3
    assert out["hpfx.trip"]["wall_us"] == 74
    assert out["hpfx.trip"]["records"] == 4
    assert out["hpfx.trip"]["idle_us"] == 10 + 5 + 22


def test_no_program_spans_no_entries():
    ev = [e for e in _events() if not e["name"].startswith("hpfx.")]
    assert program.program(ev, 0, 100) == {}


def _record(seconds, trips, calls=(1.0, 3.0)):
    return {"calls": list(calls),
            "phases": {"seconds": seconds, "trips": trips}}


@pytest.mark.parametrize("seconds, trips, want", [
    # the rescue's passes as phases inside "host_rescue"
    ({"phase1": 2.0, "host_rescue": 1.0, "rescue_self": 0.3,
      "rescue_cold": 0.3, "rescue_float64": 0.4},
     {"phase1": 20, "host_rescue": 0, "rescue_self": 5, "rescue_cold": 5,
      "rescue_float64": 9}, 0.1),
    # a rescue that ended before the float64 pass, and a window with none
    ({"phase1": 2.0, "host_rescue": 1.0, "rescue_self": 1.0},
     {"phase1": 20, "host_rescue": 0, "rescue_self": 5}, 0.0),
    ({"phase1": 2.0}, {"phase1": 20}, 0.0),
    # the rescue's trips counted in "host_rescue" itself: no split
    ({"phase1": 2.0, "host_rescue": 1.0}, {"phase1": 20, "host_rescue": 9},
     None),
])
def test_f64_rescue_share(seconds, trips, want):
    read = spec.metric_reader("solve.f64_rescue_share")
    assert read(_record(seconds, trips)) == want
    assert read({"calls": [1.0], "phases": None}) is None
