"""python -m hpfx_torch (hpfx_torch/__main__.py) against python -m hpfx.

Each command's parity case gives the same argv to both CLIs (the port's
with ``--device cpu``, float64, the JAX CLI's precision) and requires the
same exit code and the same stdout once the wall-time token is stripped;
artifacts written by one CLI are read by the other.  Then the plumbing
checks of tests/test_cli.py run on the port's CLI: exit codes, tables,
artifacts, the unknown command."""
import contextlib
import filecmp
import io
import json
import os
import re

import numpy as np
import pytest

from conftest import DATA
from hpfx.__main__ import main as jax_main
from hpfx_torch.__main__ import main as torch_main
from test_torch_foundations import one_torch_thread  # noqa: F401

NET2 = ("--buses", os.path.join(DATA, "net2_buses.csv"),
        "--lines", os.path.join(DATA, "net2_lines.csv"))


def main(argv):
    """The port's CLI on the CPU (float64)."""
    return torch_main([*argv, "--device", "cpu"])


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    # the wall time: "(0.12s incl. compile)", "12.34s incl. compile"
    return rc, re.sub(r"\d+\.\d+s\b", "<t>s", buf.getvalue())


PARITY = {
    "solve": ["solve", *NET2, "--hmax", "13", "--bg", "5:0.02:0"],
    "scan": ["scan", *NET2, "--operational"],
    "modes": ["modes", *NET2, "--operational", "--sensitivity"],
    "sweep": ["sweep", *NET2, "--batch", "16", "--seed", "3"],
    "report": ["report", *NET2, "--waveshape", "--p1459", "--en50160"],
    "estimate": ["estimate", *NET2, "--meter", "1", "--scales0", "0.5"],
    "filter": ["filter", *NET2, "--bus", "2", "--steps", "3"],
    "afilter": ["afilter", *NET2, "--bus", "3", "--orders", "5", "7"],
    "export": ["export", *NET2],
    "place": ["place", *NET2, "--bus", "2", "3", "--h-tune", "4.85",
              "--x-cap", "0.5", "1.0", "--n-filters", "2"],
    "capacity": ["capacity", *NET2, "--batch", "16", "--hmax", "5",
                 "--limit", "0.5"],
    "assess": ["assess", *NET2, "--batch", "8", "--levels", "5:1000",
               "--default-level", "1000"],
    "timeseries": ["timeseries", *NET2, "--steps", "6", "--chunk", "3"],
    "contingency": ["contingency", *NET2, "--hmax", "5", "--draws", "4"],
}


def test_parity_covers_every_command():
    from hpfx.__main__ import build_parser as jax_parser
    from hpfx_torch.__main__ import build_parser as torch_parser
    cmds = lambda p: set(p._subparsers._group_actions[0].choices)
    assert cmds(jax_parser()) == cmds(torch_parser()) == set(PARITY)


@pytest.mark.parametrize("cmd", sorted(PARITY))
def test_cli_parity(cmd, tmp_path):
    """Same exit code, same stdout (every printed digit); the artifact of
    either CLI is the input or the twin of the other's."""
    argv = list(PARITY[cmd])
    jax_argv, torch_argv = list(argv), [*argv, "--device", "cpu"]
    if cmd == "estimate":
        # each CLI fits the other's solve --json
        for fn, path, extra in ((jax_main, "j.json", []),
                                (torch_main, "t.json", ["--device", "cpu"])):
            assert fn(["solve", *NET2, "--json", str(tmp_path / path),
                       *extra]) == 0
        jax_argv += ["--measurements", str(tmp_path / "t.json")]
        torch_argv += ["--measurements", str(tmp_path / "j.json")]
    if cmd == "export":
        jax_argv += ["--dss", str(tmp_path / "case.dss")]
        torch_argv += ["--dss", str(tmp_path / "case.dss")]
    rc_j, out_j = _run(jax_main, jax_argv)
    if cmd == "export":
        os.replace(tmp_path / "case.dss", tmp_path / "jax.dss")
    rc_t, out_t = _run(torch_main, torch_argv)
    assert rc_j == rc_t
    if cmd == "estimate":
        out_j = out_j.replace(str(tmp_path / "t.json"), "<json>")
        out_t = out_t.replace(str(tmp_path / "j.json"), "<json>")
    assert out_t.splitlines() == out_j.splitlines()
    if cmd == "export":
        assert filecmp.cmp(tmp_path / "jax.dss", tmp_path / "case.dss",
                           shallow=False)


def test_artifacts_cross_read(tmp_path):
    """The port's solve --vlog/--json and timeseries --json read back
    through the JAX package, and equal the JAX CLI's."""
    import hpfx
    out = {}
    for tag, fn, extra in (("j", jax_main, []),
                           ("t", torch_main, ["--device", "cpu"])):
        v, s, ts = (tmp_path / f"{tag}{k}" for k in ("v.json", "s.json",
                                                     "ts.json"))
        assert fn(["solve", *NET2, "--hmax", "5", "--vlog", str(v),
                   "--json", str(s), *extra]) == 0
        assert fn(["timeseries", *NET2, "--hmax", "5", "--steps", "4",
                   "--json", str(ts), *extra]) == 3
        out[tag] = (hpfx.read_vlog(str(v)), json.loads(s.read_text()),
                    json.loads(ts.read_text()))
    (vj, sj, tj), (vt, st, tt) = out["j"], out["t"]
    # the logs hold raw iterates rounded to 10 decimals: the initial state
    # and the converged one agree to that; the cold start's transient
    # between them amplifies the two packages' rounding (residuals ~1e2;
    # measured 4e-10 to 3.4e-8 from one run to another)
    np.testing.assert_array_equal(vt[2], vj[2])
    for a, b in zip(vj[:2], vt[:2]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(b[[0, -1]], a[[0, -1]], rtol=0,
                                   atol=1.01e-10)
    assert sj.keys() == st.keys() and sj["n_iter"] == st["n_iter"]
    for k in ("V_m", "V_a", "THD_F", "THD_R"):
        np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=1e-10)
    assert tj["converged"] == tt["converged"]
    np.testing.assert_allclose(tt["thd"], tj["thd"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tt["profile"], tj["profile"])


def test_device_defaults_to_the_card(monkeypatch):
    """With no --device the CLI asks for the card and says so when there is
    none; it never carries on on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        torch_main(["solve", *NET2])


# ---- tests/test_cli.py's checks on the port's CLI -------------------------

def test_solve_prints_thd_table_and_exit_code(capsys):
    rc = main(["solve", *NET2, "--hmax", "25"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged=True" in out
    assert "THD_F" in out
    # 4 bus rows
    assert sum(line.strip().startswith(("0 ", "1 ", "2 ", "3 "))
               for line in out.splitlines()) == 4


def test_solve_artifacts_roundtrip(tmp_path, capsys):
    vlog = tmp_path / "v.json"
    sol = tmp_path / "s.json"
    rc = main(["solve", *NET2, "--vlog", str(vlog), "--json", str(sol)])
    capsys.readouterr()
    assert rc == 0
    # vlog is strict JSON in the interchange schema; solution JSON has
    # the (H, n) tensors
    import hpfx_torch
    V_m, V_a, harms = hpfx_torch.read_vlog(str(vlog))
    d = json.loads(sol.read_text())
    assert d["converged"] is True
    assert np.asarray(d["V_m"]).shape == V_m.shape[1:]
    # the logged final iterate's THD matches the solution's to cleanup
    # (write_vlog stores raw pre-cleanup iterates; just gate shape/finite)
    assert np.isfinite(np.asarray(d["THD_F"])).all()


def test_solve_arrow_matches_dense(capsys):
    rc = main(["solve", *NET2, "--solver", "arrow"])
    out_arrow = capsys.readouterr().out
    rc2 = main(["solve", *NET2])
    out_dense = capsys.readouterr().out
    assert rc == rc2 == 0
    # identical printed tables (fp-noise differences are below the 4/5
    # printed decimals)
    tail = lambda s: "\n".join(s.splitlines()[1:])
    assert tail(out_arrow) == tail(out_dense)


def test_scan_operational_flag(capsys):
    rc = main(["scan", *NET2, "--operational"])
    out = capsys.readouterr().out
    assert rc == 0 and "operational" in out and "worst h" in out
    rc = main(["scan", *NET2])
    out = capsys.readouterr().out
    assert rc == 0 and "passive" in out


def test_sweep_summary(capsys):
    rc = main(["sweep", *NET2, "--batch", "16", "--seed", "3"])
    out = capsys.readouterr().out
    assert rc in (0, 2)
    assert "B=16" in out and "conv=" in out


def test_sweep_warm_and_background(capsys):
    rc = main(["sweep", *NET2, "--batch", "8", "--seed", "1",
               "--warm", "linear", "--bg-spread", "5:0.03",
               "--bg-spread", "7:0.02"])
    out = capsys.readouterr().out
    assert rc in (0, 2)
    assert "B=8" in out and "conv=" in out


def test_filter_design(capsys):
    rc = main(["filter", *NET2, "--bus", "2", "--steps", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "maxTHD" in out and "h_tune" in out


def test_unknown_command_errors():
    with pytest.raises(SystemExit):
        main(["frobnicate"])


def test_report_flows_and_ieee519(capsys):
    rc = main(["report", *NET2])
    out = capsys.readouterr().out
    assert rc == 3                        # net2 is non-compliant
    assert "total loss" in out and "IEEE-519" in out
    assert "K-factor" in out and "I TDD %" in out
    assert "False" in out and "True" in out
    # tighter class flips nothing to compliant
    rc2 = main(["report", *NET2, "--v-kv", "500"])
    out2 = capsys.readouterr().out
    assert rc2 == 3 and "individual<=1.0%" in out2


def test_filter_bank_cli(capsys):
    rc = main(["filter", *NET2, "--bus", "2", "3", "--steps", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "2 branch(es)" in out and "bus 3:" in out


def test_estimate_roundtrip(tmp_path, capsys):
    sol = tmp_path / "meas.json"
    rc = main(["solve", *NET2, "--json", str(sol)])
    capsys.readouterr()
    assert rc == 0
    rc = main(["estimate", *NET2, "--measurements", str(sol),
               "--meter", "1", "--scales0", "0.5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "fitted 1 device scale(s)" in out
    # the fitted scale must come back to 1.0 (the solve's level)
    fitted = float(out.split(":")[1].split()[0])
    assert abs(fitted - 1.0) < 1e-3


def test_assess_quantile_table(capsys):
    """assess prints a per-bus quantile table; net2 at nominal penetration
    exceeds tight planning levels (exit 3) and meets loose ones (exit 0)."""
    rc = main(["assess", *NET2, "--batch", "8", "--quantiles", "0.5", "0.95",
               "--levels", "5:1000", "--default-level", "1000"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "conv=1.0000" in out and "compliant=True" in out
    rows = [l.split() for l in out.splitlines()
            if l.strip() and l.split()[0].isdigit()]
    assert len(rows) == 4 and all(len(r) == 4 for r in rows)
    # p50 <= p95 on every bus
    assert all(float(r[1]) <= float(r[2]) + 1e-12 for r in rows)

    rc = main(["assess", *NET2, "--batch", "8", "--levels", "5:0.01"])
    assert rc == 3
    assert "compliant=False" in capsys.readouterr().out


def test_timeseries_study(tmp_path, capsys):
    prof = tmp_path / "profile.csv"
    np.savetxt(prof, np.linspace(0.8, 1.1, 6), delimiter=",")
    js = tmp_path / "ts.json"
    rc = main(["timeseries", *NET2, "--profile", str(prof), "--chunk", "3",
               "--json", str(js)])
    out = capsys.readouterr().out
    # net2 at full device penetration violates the <=1kV class: exit 3
    assert rc == 3
    assert "T=6 steps" in out and "conv=1.0000" in out
    import json
    d = json.load(open(js))
    assert len(d["thd"]) == 6 and all(d["converged"])
    assert d["profile"][0] == pytest.approx(0.8)


def test_contingency_table(capsys):
    """contingency ranks net2's four line outages; --alert gates exit."""
    rc = main(["contingency", *NET2, "--hmax", "5", "--alert", "1e9"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "N-1 line-outage screen: 4 outages" in out
    rows = [l.split() for l in out.splitlines()
            if l.strip() and l.split()[0].isdigit()]
    assert len(rows) == 4 and all(r[2] == "ok" for r in rows)
    deltas = [float(r[4]) for r in rows]
    assert deltas == sorted(deltas, reverse=True)

    rc = main(["contingency", *NET2, "--hmax", "5", "--type", "shunt"])
    out = capsys.readouterr().out
    assert "N-1 shunt-outage screen: 1 outages" in out
    # the shunt outage LOWERS net2's THD -> no alert
    assert rc == 0

    rc = main(["contingency", *NET2, "--hmax", "5", "--scan"])
    out = capsys.readouterr().out
    assert rc == 0 and "resonance-shift scan: 4 line outages" in out
    amps = [float(l.split()[3]) for l in out.splitlines()
            if l.strip() and l.split()[0].isdigit()]
    assert len(amps) == 4 and amps == sorted(amps, reverse=True)


def test_solve_background_flag_raises_thd(capsys):
    """--bg superposes an upstream spectrum: THD rises on every bus vs
    the clean-grid solve, through the same CLI table."""
    rc0 = main(["solve", *NET2])
    out0 = capsys.readouterr().out
    rc1 = main(["solve", *NET2, "--bg", "5:0.02:0", "--bg", "7:0.01:30"])
    out1 = capsys.readouterr().out
    assert rc0 == 0 and rc1 == 0

    def thd_col(out):
        rows = [line.split() for line in out.splitlines()
                if line.strip().startswith(("0 ", "1 ", "2 ", "3 "))]
        return np.asarray([float(r[3]) for r in rows])

    t0, t1 = thd_col(out0), thd_col(out1)
    assert t0.shape == t1.shape == (4,)
    assert np.all(t1 > t0)


def test_solve_seq_aware_flag(capsys):
    """--seq-aware routes through hpf_sequence: converges, and the
    neutral z0 (1:1, no blocking) reproduces the plain solve's table."""
    rc = main(["solve", *NET2, "--hmax", "5",
               "--seq-aware", "--z0-scale", "1.0:1.0"])
    base = capsys.readouterr().out
    assert rc == 0
    rc2 = main(["solve", *NET2, "--hmax", "5"])
    plain = capsys.readouterr().out
    assert rc2 == 0
    assert base.splitlines()[1:] == plain.splitlines()[1:]  # skip timing
    # a real zero-sequence system changes the solution
    rc3 = main(["solve", *NET2, "--hmax", "5", "--seq-aware",
                "--xg", "1:0.1"])
    seq = capsys.readouterr().out
    assert rc3 == 0 and "converged=True" in seq
    assert seq.splitlines()[2:] != plain.splitlines()[2:]


def test_solve_skin_flag(capsys):
    rc = main(["solve", *NET2, "--hmax", "25", "--skin", "cigre_oh"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged=True" in out
    rc2 = main(["solve", *NET2, "--hmax", "25"])
    out2 = capsys.readouterr().out
    assert rc2 == 0
    # the correction changes the solved THD table
    assert out.splitlines()[-1] != out2.splitlines()[-1]
    with pytest.raises(SystemExit, match="seq-aware"):
        main(["solve", *NET2, "--skin", "cigre_oh", "--seq-aware"])


def test_solve_matpower_input(tmp_path, capsys):
    from test_matpower import CASE
    p = tmp_path / "case4.m"
    p.write_text(CASE)
    rc = main(["solve", "--matpower", str(p), "--nonlinear", "4:SMPS",
               "--slack-xsh", "3.125e-05", "--hmax", "5"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged=True" in out
    with pytest.raises(SystemExit, match="--buses/--lines or --matpower"):
        main(["solve", "--hmax", "5"])


def test_report_en50160_flag(capsys):
    rc = main(["report", *NET2, "--en50160"])
    out = capsys.readouterr().out
    assert rc == 3                        # net2 violates both standards
    assert "EN 50160" in out and "binding h" in out


def test_place_command(capsys):
    rc = main(["place", *NET2, "--bus", "2", "3", "--h-tune", "4.85",
               "--x-cap", "0.5", "1.0", "--n-filters", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "base worst THD_F" in out and "greedy bank" in out
    assert "worstTHD" in out


def test_report_p1459_flag(capsys):
    rc = main(["report", *NET2, "--p1459"])
    out = capsys.readouterr().out
    assert rc == 3                        # unchanged compliance verdict
    assert "IEEE 1459" in out and "dpf" in out
    # one row per line with both power factors populated
    rows = [ln for ln in out.splitlines()
            if ln.strip() and ln.split()[0].isdigit()
            and "IEEE 1459" not in ln]
    assert len(rows) >= 4


def test_solve_long_line_flag(capsys):
    # net2 lines have B=0 -> the corrected solve is identical physics
    rc = main(["solve", *NET2, "--long-line"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged=True" in out
    rc2 = main(["solve", *NET2, "--long-line", "--skin", "cigre_oh"])
    assert rc2 == 0
    with pytest.raises(SystemExit, match="--long-line cannot combine"):
        main(["solve", *NET2, "--long-line", "--seq-aware"])


def test_solve_converter_devices(capsys):
    rc = main(["solve", *NET2, "--converter", "3:six_pulse:0.1:15:5"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged=True" in out
    # report rides the same devices
    rc2 = main(["report", *NET2, "--converter", "3:twelve_pulse:0.2"])
    out2 = capsys.readouterr().out
    assert rc2 in (0, 3) and "IEEE-519" in out2
    with pytest.raises(SystemExit, match="must cover exactly"):
        main(["solve", *NET2, "--converter", "2:six_pulse:0.1"])
    with pytest.raises(SystemExit, match="BUS:KIND:I1"):
        main(["solve", *NET2, "--converter", "2:six_pulse"])


def test_afilter_command(capsys):
    rc = main(["afilter", *NET2, "--bus", "3", "--orders", "5", "7"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "active filter at bus 3" in out and "rating" in out
    # exactly the two targeted orders in the spectrum table (bus, h, ...)
    rows = [ln.split() for ln in out.splitlines()
            if ln.strip().startswith("3 ")]
    assert [r[1] for r in rows] == ["5", "7"]


def test_export_opendss_command(tmp_path, capsys):
    dss = tmp_path / "case.dss"
    rc = main(["export", *NET2, "--dss", str(dss)])
    out = capsys.readouterr().out
    assert rc == 0 and "OpenDSS element definitions" in out
    txt = dss.read_text()
    assert "New Circuit.hpfx" in txt and "Solve mode=harmonics" in txt


def test_afilter_bank_cli(capsys):
    rc = main(["afilter", *NET2, "--bus", "2", "3", "--orders", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "active filter at bus 2" in out
    assert "active filter at bus 3" in out


def test_report_waveshape_flag(capsys):
    rc = main(["report", *NET2, "--waveshape"])
    out = capsys.readouterr().out
    assert rc == 3 and "waveshape" in out and "crest" in out
    lines = out.splitlines()
    start = next(i for i, l in enumerate(lines) if "waveshape" in l)
    rows = []
    for l in lines[start + 2:]:
        if not (l.strip() and l.split()[0].isdigit()):
            break
        rows.append(l.split())
    crest = [float(r[3]) for r in rows]
    assert len(crest) == 4
    assert abs(crest[0] - 1.414) < 0.01       # clean slack
    assert max(crest) > 2.0                   # distorted feeder
