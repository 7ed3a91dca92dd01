"""The metrics and cells added with the IEEE 33-bus feeder: the readers on
synthetic records, the span metrics on a program without their functions,
and the two new cells at a test's size: the program passes their check,
the control fails it, and a planted fault comes out as not correct."""
import pytest
import torch

import control
import hpfx_torch.lanes
from conftest import run_cell
from harness import roofline, spec, stats
from test_portbench_faults import FAULTS

#: the new cells' traffic cut to what a test holds: the mix's depth and
#: batch
SIZES = {"net2.h25-mc64k": (9, 16), "ieee33bw.h25-mc512": (5, 4)}

SHARES = {"trip.block_solve_share": "solve_arrow_blocks_lanes",
          "trip.capacitance_solve_share": "solve_capacitance_lanes"}

#: the new cells' twins of accepted metrics, each read by the metric
#: it names
TWINS = {f"{metric}.{cell}": metric
         for cell, metrics in {
             "net2.h25-mc64k": ("lanes.trips_per_sweep",
                                "trip.phase1_trip_ms", "k1_roofline",
                                "device.idle_share", "lanes.restart_share"),
             "ieee33bw.h25-mc512": ("device.idle_share",
                                    "lanes.trips_per_sweep",
                                    "trip.phase1_trip_ms",
                                    "ops.solve_share",
                                    "k4_roofline")}.items()
         for metric in metrics}


def small(name):
    """The new cell ``name`` with its traffic cut to a test's size."""
    cell = spec.cell(name)
    h, b = SIZES[name]
    cell.traffic = dict(cell.traffic, h_max=h, batch=b)
    return cell


def _record():
    return {"calls": [0.5, 0.7, 1.0],
            "device": {"busy_us": 1.5e6, "wall_us": 2e6, "records": 3,
                       "by_name": {"gj_kernel_carried<160, 160>(a)": 4e3,
                                   "gj_panel_kernel<1, 32>(b)": 2e3,
                                   "gj_kernel<32>(c)": 1e3},
                       "launches": {("gj_kernel_carried", (130, 65, 6656)): 3,
                                    ("gj_kernel_carried", (128, 1, 512)): 2,
                                    ("gj_panel_kernel", (832, 32, 512)): 26,
                                    ("gj_kernel", (26, 1, 65536)): 4}},
            "phases": {"trips": {"phase1": 24, "rescue_phase2": 3},
                       "seconds": {"phase1": 0.9, "rescue_phase2": 0.1,
                                   "cold_restart": 0.05}},
            "spans": {"busy_us": 200.0, "wall_us": 300.0,
                      "under": {"*": 120.0, "solve_arrow_blocks_lanes": 50.0,
                                "solve_capacitance_lanes": 60.0},
                      "idle_by_host": {}}}


def test_k2_against_its_roofline():
    want = 100 * (3 * roofline.bound(*roofline.solve_work(130, 65, 6656))[0]
                  + 2 * roofline.bound(*roofline.solve_work(128, 1, 512))[0]
                  ) / 4e-3
    assert spec.metric_reader("k2_roofline")(_record()) == pytest.approx(want)


def test_k4_in_the_feeder_cell_is_k4_roofline():
    rec = _record()
    got = spec.metric_reader("k4_roofline.ieee33bw.h25-mc512")(rec)
    assert got == pytest.approx(
        100 * 26 * roofline.bound(*roofline.panel_work(832, 32, 512))[0]
        / 2e-3)


def test_p90_of_the_64k_cell():
    read = spec.metric_reader("sweep_p90_s.net2.h25-mc64k")
    assert read(_record()) == stats.p90([0.5, 0.7, 1.0])


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_a_twin_reads_what_its_metric_reads(twin):
    rec = _record()
    got = spec.metric_reader(twin)(rec)
    assert got is not None
    assert got == spec.metric_reader(TWINS[twin])(rec)
    assert getattr(spec.metric_module(twin), "SPANS", ()) == getattr(
        spec.metric_module(TWINS[twin]), "SPANS", ())


@pytest.mark.parametrize("name", sorted(SHARES))
def test_trip_solve_shares(name):
    mod = spec.metric_module(name)
    assert mod.SPANS == (f"hpfx_torch.lanes:{SHARES[name]}",)
    rec = _record()
    assert mod.read(rec) == rec["spans"]["under"][SHARES[name]] / 200.0


@pytest.mark.parametrize("name", sorted(SHARES))
def test_trip_solve_shares_without_the_function(name, monkeypatch):
    """On a program whose arrow step has no such function, the metric asks
    for no span and reads nothing."""
    monkeypatch.delattr(hpfx_torch.lanes, SHARES[name])
    mod = spec.metric_module(name)
    assert mod.SPANS == ()
    rec = _record()
    del rec["spans"]["under"][SHARES[name]]
    assert mod.read(rec) is None
    assert mod.read(dict(rec, spans=None)) is None


def test_the_new_cells_find_their_files():
    for name in SIZES:
        cell = spec.cell(name)
        assert cell.chips == 1 and cell.traffic["h_max"] == 25
        layer = {m["name"] for m in cell.per_layer}
        assert {"trip.block_solve_share", "trip.capacitance_solve_share",
                "k2_roofline"} <= layer
        assert {t for t, m in TWINS.items() if t.endswith(name)} <= layer
    cfg = spec.cell("ieee33bw.h25-mc512").config
    assert cfg["settings"]["base_power"] == 1e7 and cfg["reduced"] == []
    # the port's own stop, as net1 has it
    assert "thresh_h" not in cfg["settings"]
    assert "floor_kappa" not in cfg["settings"]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_control_fails_in_a_new_cell(name):
    cell = small(name)
    for seed in (5, 2 ** 31 + 9, 2 ** 40 + 1):
        ok, numbers, _ = control.readings(cell, seed, 3, torch.device("cpu"))
        reading, limit = numbers["dv_max_pu"]
        assert ok is False and reading > 3 * limit, (seed, reading, limit)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_the_program_passes_in_a_new_cell(name, on_cpu, capsys):
    res = run_cell(small(name), capsys)
    assert res["correct"], res
    assert res["checks"]["dv_max_pu"]["value"] \
        <= res["checks"]["dv_max_pu"]["limit"] / 3
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("name", sorted(SIZES))
def test_an_altered_answer_in_a_new_cell_is_not_correct(
        name, on_cpu, monkeypatch, capsys):
    FAULTS["answer_altered"](monkeypatch)
    res = run_cell(small(name), capsys)
    assert res["correct"] is False, res
