"""Without a card the run fails and prints no result; it never falls back
to the CPU.  Nor does it run where the checkout holds nothing but the
benchmark."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT
from harness import spec

CMD = ["portbench/run.py", "--workload", "net2.h25-mc16k", "--seed",
       "3000000019", "--seconds", "1", "--trace", "0"]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_no_card_no_result(workload):
    _no_card()
    cmd = list(CMD)
    cmd[2] = workload
    p = subprocess.run([sys.executable, *cmd], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    _no_card()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, *CMD], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
