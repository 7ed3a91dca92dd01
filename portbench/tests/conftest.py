"""The benchmark's own tests: on the CPU at small sizes, with the port's
plain twins in place of its CUDA kernels.  Run them from the root of the
checkout:

    python -m pytest portbench/tests -q

The repository's own suite (``tests/``) does not collect them."""
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH]

from harness import cards, cli, spec  # noqa: E402

#: a cell's traffic cut to what a test holds: the mix's depth and batch
SMALL = {"net2.h25-mc16k": (9, 16), "net1.h25-mc2k": (9, 8),
         "net2.h25-mc64k-x4": (9, 16), "net1.h51-mc256": (9, 8)}
#: the four-card cell, whose files are under portbench/ though
#: BENCHMARK.json does not list it yet (PERF.md, Open questions)
X4 = {"name": "net2.h25-mc64k-x4", "config": "net2",
      "traffic": "h25-mc64k-x4", "chips": 4}


def bench_with_x4(root=spec.ROOT):
    """BENCHMARK.json's contents with the four-card cell in them."""
    bench = spec.benchmark(root)
    if X4["name"] not in {w["name"] for w in bench["workloads"]}:
        bench = dict(bench, workloads=[*bench["workloads"], X4])
    return bench


def small_cell(name):
    """The cell ``name`` with its traffic cut to a test's size."""
    cell = spec.cell(name, bench=bench_with_x4())
    h, b = SMALL[name]
    cell.traffic = dict(cell.traffic, h_max=h, batch=b)
    return cell


@pytest.fixture
def on_cpu(monkeypatch):
    """Runs skip the look for cards and take the CPU."""
    torch.set_num_threads(1)
    monkeypatch.setattr(cards, "require", lambda n: None)
    monkeypatch.setattr(cards, "device", lambda rank: torch.device("cpu"))


def run_cell(cell, capsys, seed=2 ** 33 + 5, seconds=1.0, world=1):
    """One run of ``cell`` in this process; its result line."""
    args = cli.parse(["--workload", cell.name, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", "0"])
    assert cli.Run(cell, args, 0, world, 0.0).go() == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
