"""The check separates the program from its control: the program's
answers on the CPU pass each cell's limit; the control, the reference in
float32 with TF32 products put in the program's place, fails it."""
import pytest
import torch

import control
from conftest import SMALL, run_cell, small_cell
from harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]
         if w["chips"] == 1]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails(name):
    cell = small_cell(name)
    for seed in (5, 2 ** 31 + 9, 2 ** 40 + 1):
        ok, numbers, _ = control.readings(cell, seed, 3, torch.device("cpu"))
        reading, limit = numbers["dv_max_pu"]
        assert ok is False and reading > 3 * limit, (seed, reading, limit)


@pytest.mark.parametrize("what", ["float32", "port64"])
def test_the_witnesses_pass(what):
    cell = small_cell("net1.h51-mc256")
    ok, numbers, _ = control.readings(cell, 7, 2, torch.device("cpu"), what)
    reading, limit = numbers["dv_max_pu"]
    assert ok and reading < limit, (reading, limit)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(name, on_cpu, capsys):
    res = run_cell(small_cell(name), capsys)
    assert res["correct"], res
    assert res["checks"]["dv_max_pu"]["value"] \
        <= res["checks"]["dv_max_pu"]["limit"] / 3
    assert res["attempted"] > 0 and res["failed"] == 0
