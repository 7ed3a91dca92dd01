"""A run whose timed path is broken underneath comes out not correct:
once for each fault a cell can have.  The runs skip the look for a card
and take the CPU at a test's size (conftest.py)."""
import json
import os
import sys

import pytest
import torch

from conftest import HERE, bench_with_x4, run_cell, small_cell
from harness import cli, spec

import hpfx_torch.lanes as lanes

ONE_CARD = ["net2.h25-mc16k", "net1.h25-mc2k", "net1.h51-mc256"]


def step_unchanged(monkeypatch):
    """Every Newton step returns a zero update: the state never moves."""
    monkeypatch.setattr(lanes, "arrow_step_lanes",
                        lambda V_m, V_a, f, *a, **k: torch.zeros_like(f))


def half_batch(monkeypatch):
    """Each call solves the first half of its batch and hands those
    answers out for the second half too."""
    def entry(name):
        mod = spec._module("entries", name)

        class Half:
            SUPPORTS_LOG = mod.SUPPORTS_LOG
            FLOAT64_RESCUE = mod.FLOAT64_RESCUE

            @staticmethod
            def make(*a):
                call = mod.make(*a)

                def half(sc, log=None):
                    h = sc.batch // 2
                    res = call(type(sc)(*(None if x is None else x[:h]
                                          for x in sc)), log)
                    two = lambda t: torch.cat([t, t])[:sc.batch]
                    return res._replace(V_m=two(res.V_m), V_a=two(res.V_a),
                                        converged=two(res.converged),
                                        n_iter=two(res.n_iter))
                return half
        return Half

    monkeypatch.setattr(spec, "entry", entry)


def answer_altered(monkeypatch):
    """Every answer's third harmonic magnitude moved by 5e-2 pu where the
    sweep assembles its result."""
    orig = lanes._lanes_result

    def altered(V_m, *a, **k):
        V_m = V_m.clone()
        V_m[1] += 5e-2
        return orig(V_m, *a, **k)

    monkeypatch.setattr(lanes, "_lanes_result", altered)


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ONE_CARD)
def test_a_fault_is_not_correct(name, fault, on_cpu, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    res = run_cell(small_cell(name), capsys)
    assert res["correct"] is False, res


def _ranks(name, fault, monkeypatch, capfd):
    """A CPU run of a several-card cell: gloo ranks started by the run's
    own launcher, each through rank_fault.py with ``fault``."""
    torch.set_num_threads(1)
    monkeypatch.setattr(cli.cards, "require", lambda n: None)
    monkeypatch.setattr(cli, "build_kernels", lambda: None)
    base = cli.child_command
    monkeypatch.setattr(cli, "child_command", lambda *a: [
        sys.executable, os.path.join(HERE, "rank_fault.py"), fault,
        *base(*a)[2:]])
    cell = spec.cell
    monkeypatch.setattr(spec, "cell", lambda n, root=spec.ROOT: cell(
        n, root, bench_with_x4(root)))
    argv = ["--workload", name, "--seed", str(2 ** 35 + 3), "--seconds",
            "1", "--trace", "0"]
    assert cli.main(argv, 0.0) == 0
    return json.loads(capfd.readouterr().out.strip().splitlines()[-1])


def test_four_ranks_are_correct(monkeypatch, capfd):
    res = _ranks("net2.h25-mc64k-x4", "none", monkeypatch, capfd)
    assert res["correct"] is True, res
    assert res["device"]["count"] == 4


def test_the_exchange_left_out_is_not_correct(monkeypatch, capfd):
    res = _ranks("net2.h25-mc64k-x4", "no_exchange", monkeypatch, capfd)
    assert res["correct"] is False, res
