"""Everything a run needs, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.  A
cell ``<config>.<traffic>`` has a file of its own,
``portbench/workloads/<cell>.json`` (its sweep entry and the entry's
arguments, the correctness sample and limits, the calls to trace), and
names its configuration, ``portbench/configs/<config>.json``, and its
traffic mix, ``portbench/traffic/<traffic>.json``.  A sweep entry is
``portbench/entries/<entry>.py`` and a per-layer metric
``portbench/metrics/<metric>.py``.  A later cell or metric is added as
new files; none of these is edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str):
    with open(path) as fh:
        return json.load(fh)


def _module(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark, with all it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list

    @property
    def entry(self) -> str:
        return self.workload["entry"]


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, root: str = ROOT, bench: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``, its
    contents), its files read."""
    bench = benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(by_name)}")
    w = by_name[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(BENCH_DIR, "configs",
                                  f"{w['config']}.json")),
        traffic=_json(os.path.join(BENCH_DIR, "traffic",
                                   f"{w['traffic']}.json")),
        workload=_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json")),
        end_to_end=e2e, per_layer=per_layer)


def entry(name: str):
    """The sweep entry adapter ``portbench/entries/<name>.py``."""
    return _module("entries", name)


def metric_module(name: str):
    """``portbench/metrics/<name>.py``: its ``read(record)`` returns the
    metric, or None where the record holds nothing to read; an optional
    ``SPANS`` lists the ``"module:function"`` spans it reads."""
    return _module("metrics", name)


def metric_reader(name: str):
    """The reader ``read(record)`` of metric ``name``."""
    return metric_module(name).read
