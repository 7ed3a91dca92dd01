"""Every cell, configuration, traffic mix, entry and metric of
BENCHMARK.json is found by its name."""
import os

import pytest

from conftest import BENCH
from harness import spec

BENCH_JSON = spec.benchmark()
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = spec.cell(name)
    assert cell.traffic["batch"] > 0 and cell.traffic["h_max"] >= 1
    assert callable(spec.entry(cell.entry).make)
    assert cell.workload["limits"]["dv_max_pu"] > 0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer, "a cell reports at least one per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_every_file_named():
    for c in BENCH_JSON["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for m in BENCH_JSON["end_to_end"] + BENCH_JSON["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.new_metric-1.py").write_text(
        "def read(rec):\n    return rec['calls'][0]\n")
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    assert spec.metric_reader("x.new_metric-1")({"calls": [7.0]}) == 7.0


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell("no.such-cell")
    with pytest.raises(FileNotFoundError):
        spec.entry("no_such_entry")


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    for m in BENCH_JSON["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", CELLS):
            assert "workloads" not in moved or w in moved["workloads"], \
                (m["name"], w)
