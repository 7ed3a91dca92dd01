"""The port's offline device pipeline against the JAX package, on the CPU
in float64: the Norton-equivalent fits of hpfx_torch.devices, the
measurement pipeline (smps.mat -> fit -> NE table -> device set), the
rectifier time loop (the plain twin of rectifier_kernel) and the sweep
that characterizes a circuit, the full circle into the solver, and the
worked examples (Fuchs against validation/I_log.json, the Almeida
two-port).

Tolerances: the fits to FIT_REL (1e-10) of their scale; the pipeline's
numpy stages bit for bit; the rectifier's float32 supply bit for bit and
its samples and spectra to SAMPLE_REL (1e-10) of max |i| against
hpfx.simulate as it stands (its sweep computes the supply in float32:
the port evaluates it the same way, glibc's sinf included); the solves to
FIT_TOL (1e-8) with identical counts.  Short protocols (one cycle from
t = 0 at dt = 1e-5, two applied harmonics): the reference's 80,000-step
sweep belongs to the card, but for its supply, which the shipped-table
test holds over every sample time of an EV sweep."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import ne_pipeline as jne
from hpfx import simulate as jsim
from hpfx.examples import linear_hcne_twoport as j_twoport
from hpfx.examples import solve_fuchs as j_solve_fuchs
from hpfx.network import NONLINEAR, PQ, SLACK
from hpfx_torch import ne_pipeline as tne
from hpfx_torch import simulate as tsim
from hpfx_torch.examples import fuchs as tfuchs
from hpfx_torch.examples import linear_hcne_twoport as t_twoport

from test_devices import ALMEIDA_I_N, ALMEIDA_V, ALMEIDA_Y_N
from test_torch_estimate import FIT_TOL, torch_side
from test_torch_foundations import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "hpfx", "data")
#: the fits and the two-port against the JAX package, of their scale
FIT_REL = 1e-10
#: rectifier samples and spectra, of max |i|
SAMPLE_REL = 1e-10
#: the short protocol of these tests
SHORT = dict(t_start=0.0, cycles=1, dt=1e-5, substeps=4,
             harm_freqs=(150.0, 250.0), h_max=300.0)


def cx_np(c):
    """A Cx of either package as numpy complex."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def rel_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def test_ne_fits_match_jax():
    """fit_coupled_ne on Almeida's paper case and on seeded measurements,
    fit_uncoupled_ne, ne_injection (coupled and uncoupled) and
    ne_selftest."""
    rng = np.random.default_rng(5)
    H = 5
    cplx = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    I_alm = np.stack([ALMEIDA_I_N - ALMEIDA_Y_N @ v for v in ALMEIDA_V])
    for V, I in ((ALMEIDA_V, I_alm), (cplx(H + 1, H), cplx(H + 1, H))):
        jI, jY = hpfx.fit_coupled_ne(jnp.asarray(V), jnp.asarray(I))
        tI, tY = ht.fit_coupled_ne(V, I, device="cpu")
        rel_close(cx_np(tI), cx_np(jI), FIT_REL)
        rel_close(cx_np(tY), cx_np(jY), FIT_REL)
        v = cplx(V.shape[1])
        rel_close(cx_np(ht.ne_injection(tI, tY, v, device="cpu")),
                  cx_np(hpfx.ne_injection(jI, jY, jnp.asarray(v))), FIT_REL)
        assert float(ht.ne_selftest(tI, tY, V, I, device="cpu")) == \
            pytest.approx(float(hpfx.ne_selftest(jI, jY, V, I)), abs=1e-12)
    rel_close(cx_np(tY), cx_np(jY), FIT_REL)
    V1, I1, V2, I2 = (cplx(H) for _ in range(4))
    jI, jY = hpfx.fit_uncoupled_ne(*(jnp.asarray(a) for a in (V1, I1, V2, I2)))
    tI, tY = ht.fit_uncoupled_ne(V1, I1, V2, I2, device="cpu")
    rel_close(cx_np(tI), cx_np(jI), FIT_REL)
    rel_close(cx_np(tY), cx_np(jY), FIT_REL)
    rel_close(cx_np(ht.ne_injection(tI, tY, V1, device="cpu")),
              cx_np(hpfx.ne_injection(jI, jY, jnp.asarray(V1))), FIT_REL)
    assert float(ht.ne_selftest(tI, tY, V1, I1, device="cpu")) < 1e-12
    with pytest.raises(ValueError, match="H\\+1"):
        ht.fit_coupled_ne(cplx(H, H), cplx(H, H), device="cpu")


def same_fit(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(b, f.name),
                                      getattr(a, f.name), err_msg=f.name)


def test_smps_mat_pipeline_matches_jax(tmp_path):
    """load_measurements_mat(smps.mat) -> fit_norton_from_measurements ->
    export_ne_csv -> read_ne_csv, and the OpenDSS spectrum export, bit for
    bit against the JAX package's (both are numpy on the host)."""
    path = os.path.join(DATA, "smps.mat")
    jms, tms = jne.load_measurements_mat(path), tne.load_measurements_mat(path)
    same_fit(jms, tms)
    np.testing.assert_array_equal(tms.harmonic_cols, jms.harmonic_cols)
    jfit = jne.fit_norton_from_measurements(jms)
    tfit = tne.fit_norton_from_measurements(tms)
    same_fit(jfit, tfit)
    assert tfit.passed
    tne.export_ne_csv(tfit, str(tmp_path / "t_NE.csv"))
    jne.export_ne_csv(jfit, str(tmp_path / "j_NE.csv"))
    assert (tmp_path / "t_NE.csv").read_text() == \
        (tmp_path / "j_NE.csv").read_text()
    raw = ht.devices.read_ne_csv(str(tmp_path / "t_NE.csv"))
    for k, v in (("Y_c", tfit.Y_c), ("I_c", tfit.I_c), ("Y_uc", tfit.Y_uc),
                 ("I_uc", tfit.I_uc)):
        np.testing.assert_array_equal(raw[k], v)
    tne.export_opendss_spectrum(tms, str(tmp_path / "t.csv"))
    jne.export_opendss_spectrum(jms, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


@pytest.mark.parametrize("coupled", [True, False], ids=["c", "uc"])
def test_device_set_from_fit_matches_jax(coupled):
    fit = jne.fit_norton_from_measurements(
        jne.load_measurements_mat(os.path.join(DATA, "smps.mat")))
    s = hpfx.settings_for_hmax(9, coupled=coupled).with_(base_voltage=230.0)
    ts = ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64")
    jd = jne.device_set_from_fit(fit, s, n_nl=2)
    td = tne.device_set_from_fit(fit, ts, n_nl=2, device="cpu")
    assert td.coupled == coupled and td.Y_N.shape == jd.Y_N.shape
    np.testing.assert_array_equal(cx_np(td.I_N), cx_np(jd.I_N))
    np.testing.assert_array_equal(cx_np(td.Y_N), cx_np(jd.Y_N))
    with pytest.raises(ValueError, match="lacks"):
        tne.device_set_from_fit(fit, ht.settings_for_hmax(25), device="cpu")


def test_rectifier_circuits_match_jax():
    for f in dataclasses.fields(jsim.RectifierParams):
        assert getattr(tsim.smps_params(), f.name) == \
            getattr(jsim.smps_params(), f.name)
        for m in ("EV_1", "EV_2", "EV_4", "EV_5"):
            assert getattr(tsim.ev_params(m), f.name) == \
                getattr(jsim.ev_params(m), f.name)
    assert dataclasses.asdict(tsim.SweepProtocol()) == \
        dataclasses.asdict(jsim.SweepProtocol())
    assert dataclasses.asdict(tsim.ev_protocol("EV_5", substeps=8)) == \
        dataclasses.asdict(jsim.ev_protocol("EV_5", substeps=8))
    with pytest.raises(ValueError, match="unknown EV model"):
        tsim.ev_params("EV_3")


CIRCUITS = {"smps": (jsim.smps_params, tsim.smps_params),
            "EV_5": (lambda: jsim.ev_params("EV_5"),
                     lambda: tsim.ev_params("EV_5"))}


def _jax_run(params, cols, t_end, dt, substeps, net_freq=50.0):
    """hpfx.simulate.characterize_rectifier's vmapped run, its supply
    closure as it stands there, over simulations given as its columns
    (amplitude, phase in degrees, harmonic amplitude, frequency, phase):
    the (S, n + 1) currents and supply."""
    f, w = net_freq, 2 * np.pi

    def run(va, pa_deg, vh, fh, ph_deg):
        def source(t):
            return va * jnp.sin(w * f * t + jnp.deg2rad(pa_deg)) + \
                vh * jnp.sin(w * fh * t + jnp.deg2rad(ph_deg))
        return jsim.simulate_rectifier(params, source, t_end, dt, substeps)

    cols = [jnp.asarray(col, jnp.float32) for col in cols]
    i, v = jax.jit(jax.vmap(run))(*cols)
    return np.asarray(i), np.asarray(v)


def _jax_sweep(params, p, substeps=None):
    """The JAX package's run of every simulation of protocol ``p``."""
    hf_mag = p.fund_mags[0] if p.harm_fund_mag is None else p.harm_fund_mag
    hf_ph = (p.fund_phases_deg[0] if p.harm_fund_phase_deg is None
             else p.harm_fund_phase_deg)
    sims = [(p.fund_mags[k], p.fund_phases_deg[k], 0.0, 0.0, 0.0)
            for k in range(2)]
    sims += [(hf_mag, hf_ph, vh, fh, p.harm_phase_deg)
             for fh in p.harm_freqs for vh in p.harm_mags]
    return _jax_run(params, list(zip(*sims)), p.t_start + p.cycles
                    / p.net_freq, p.dt, substeps or p.substeps, p.net_freq)


def _protocols(circuit, **kw):
    """The (JAX, port) protocol pair of a circuit's sweep."""
    if circuit == "EV_5":
        return jsim.ev_protocol("EV_5", **kw), tsim.ev_protocol("EV_5", **kw)
    return jsim.SweepProtocol(**kw), tsim.SweepProtocol(**kw)


def test_sinf_is_the_reference_sin():
    """The float32 sin of the port's supply against the JAX package's
    float32 sin on this CPU, bit for bit: small, reduced and large
    arguments of both signs, and arguments next to multiples of pi/2."""
    rng = np.random.default_rng(7)
    x = np.concatenate([
        rng.uniform(-3000, 3000, 400_000), rng.uniform(-130, 130, 200_000),
        rng.uniform(-1, 1, 100_000), rng.uniform(-1e-3, 1e-3, 10_000),
        (np.arange(-500, 500)[:, None] * np.pi / 2
         + rng.uniform(-1e-3, 1e-3, (1000, 100))).ravel(),
        [0.0, -0.0, 1e-30, 0.75, np.pi / 4, 120.0, 119.99999, -1e7, 3e38],
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sin)(x))
    got = tsim._sinf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_simulate_rectifier_matches_jax(circuit):
    """Sample by sample over one cycle (2001 samples, 4 substeps), two
    simulations run as the JAX package's sweep runs them: a fundamental
    plus a 7th harmonic at a negative phase, and one at a negative
    fundamental phase plus a 25th harmonic."""
    jp, tp = (f() for f in CIRCUITS[circuit])
    cols = ((230 * np.sqrt(2), 184 * np.sqrt(2)), (11.5, -30.0),
            (23.0, 11.5), (350.0, 1250.0), (-23.0, 65.0))
    ij, vj = _jax_run(jp, cols, 0.02, 1e-5, 4)
    it, vt = tsim.simulate_rectifier(
        tp, tsim.SineSource.from_degrees(*cols, device="cpu"), 0.02, 1e-5, 4)
    assert it.shape == (2, 2001) and vt.shape == (2, 2001)
    np.testing.assert_array_equal(vt.numpy(), vj)
    rel_close(it.numpy(), ij, SAMPLE_REL)


@pytest.mark.parametrize("circuit", sorted(CIRCUITS))
def test_characterize_rectifier_matches_jax(circuit):
    """The sweep's supply (bit for bit), currents and assembled
    MeasurementSet (SAMPLE_REL) against the JAX package's."""
    jp, tp = (f() for f in CIRCUITS[circuit])
    proto = _protocols(circuit, **SHORT)
    src = tsim.sweep_source(proto[1], device="cpu")
    assert src.a1.shape == (6,)
    i_t, v_t = tsim.simulate_rectifier(tp, src, 0.02, 1e-5, 4)
    i_j, v_j = _jax_sweep(jp, proto[0])
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    rel_close(i_t.numpy(), i_j, SAMPLE_REL)
    tms = tsim.characterize_rectifier(tp, proto[1], device="cpu")
    jms = jsim.characterize_rectifier(jp, proto[0])
    for f in ("spectrum", "fund_V", "harm_freqs", "harm_V", "net_freq",
              "cycles"):
        np.testing.assert_array_equal(getattr(tms, f), getattr(jms, f))
    for f in ("fund_I", "harm_I"):
        rel_close(getattr(tms, f), getattr(jms, f), SAMPLE_REL)


def test_shipped_ev_table_and_its_supply():
    """validation/make_ev_tables.py's EV_1 sweep (102 simulations of
    80,001 samples x 8 substeps) in the JAX package as it stands
    reproduces the shipped ev_1_NE.csv bit for bit, and the port's supply
    equals that sweep's at every one of its sample times (the bound
    chip_smoke.py phase 23c holds the card's tables to rests on both)."""
    from hpfx.devices import read_ne_csv
    p = jsim.ev_protocol("EV_1", substeps=8)
    shipped = read_ne_csv(os.path.join(DATA, "ev_1_NE.csv"))
    fit = jne.fit_norton_from_measurements(
        jsim.characterize_rectifier(jsim.ev_params("EV_1"), p))
    for k in ("Y_c", "I_c", "Y_uc", "I_uc"):
        np.testing.assert_array_equal(getattr(fit, k), shipped[k])
    _, v_j = _jax_sweep(jsim.ev_params("EV_1"), p, substeps=1)
    src = tsim.sweep_source(tsim.ev_protocol("EV_1", substeps=8),
                            device="cpu")
    t = torch.arange(v_j.shape[1], dtype=torch.float64) * p.dt
    np.testing.assert_array_equal(src(t).numpy(), v_j)


def test_characterize_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.characterize_rectifier(tsim.smps_params(),
                                    tsim.SweepProtocol(**SHORT))


def test_full_circle_matches_jax():
    """tests/test_simulate.py's full circle at the short protocol: the
    port's sweep of 4 applied harmonics, fitted (a self-test below 1e-6),
    into device sets and the solver at H<=9, in both packages from the
    same measurements."""
    proto = tsim.SweepProtocol(**dict(SHORT, harm_freqs=(150.0, 250.0,
                                                         350.0, 450.0),
                                      h_max=500.0))
    ms = tsim.characterize_rectifier(tsim.smps_params(), proto, device="cpu")
    fit = tne.fit_norton_from_measurements(ms)
    assert fit.passed
    same_fit(jne.fit_norton_from_measurements(ms), fit)
    s = hpfx.settings_for_hmax(9, coupled=True).with_(
        base_power=10000.0, base_voltage=230.0)
    jnet = hpfx.network_from_arrays(
        bus_types=(SLACK, PQ, NONLINEAR),
        components=("gen", "load", "sim_smps"),
        P=[0, 1000, 7000], Q=[0, 500, 1000], X_sh=[0.01, 0, 0],
        line_from=[0, 1], line_to=[1, 2], R=[0.4, 0.2], X=[0.8, 0.4],
        settings=s, per_unit=False)
    jdev = jne.device_set_from_fit(fit, s, n_nl=jnet.n_nonlinear)
    ts, net, _ = torch_side(s, jnet, jdev)
    dev = tne.device_set_from_fit(fit, ts, n_nl=net.n_nonlinear,
                                  device="cpu")
    jr, tr = hpfx.hpf(jnet, jdev, s), ht.hpf(net, dev, ts)
    assert bool(tr.converged) and bool(jr.converged)
    assert int(tr.n_iter) == int(jr.n_iter)
    for f in ("V_m", "V_a"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=0,
                                   atol=FIT_TOL)


def _ilog():
    d = json.load(open(os.path.join(REPO, "validation", "I_log.json")))
    out = {}
    for r in d["data"]:
        h = 0 if r["harmonic"] == 1 else 1
        out.setdefault(r["iteration"], np.zeros(2, complex))
        out[r["iteration"]][h] = r["0"] + 1j * r["1"]
    return out


def _vlog_raw():
    d = json.load(open(os.path.join(REPO, "validation", "V_log.json")))
    out = {}
    for r in d["data"]:
        V = out.setdefault(r["iteration"], np.zeros((2, 4, 2)))
        V[0 if r["harmonic"] == 1 else 1, int(r["bus"][3:]) - 1] = \
            (r["V_m"], r["V_a"])
    return out


def test_fuchs_matches_jax_and_the_logs():
    """solve_fuchs against the JAX package's (identical iterations,
    voltages to FIT_TOL) and the reference's fixed point, and the
    analytic injection at every logged state against I_log.json."""
    jr = j_solve_fuchs()
    tr = tfuchs.solve_fuchs(device="cpu")
    assert bool(tr.converged) and int(tr.n_iter) == int(jr.n_iter)
    for f in ("V_m", "V_a"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=0,
                                   atol=FIT_TOL)
    dev = tfuchs.fuchs_device_set(tfuchs.fuchs_settings(), device="cpu")
    ilog = _ilog()
    states = _vlog_raw()
    for it, V in states.items():
        if it not in ilog:
            continue
        got = dev.injections(torch.tensor(V[:, 3, 0])[:, None],
                             torch.tensor(V[:, 3, 1])[:, None])
        np.testing.assert_allclose(cx_np(got)[0], ilog[it], atol=2e-9,
                                   err_msg=str(it))


def test_linear_hcne_twoport_matches_jax():
    z_f = 0.05 + 0.25j
    Y_line = np.array([1 / z_f, 1 / (1.5 * z_f), 1 / (2 * z_f)])
    jo = j_twoport(Y_line, ALMEIDA_I_N, ALMEIDA_Y_N, ALMEIDA_V[2])
    to = t_twoport(Y_line, ALMEIDA_I_N, ALMEIDA_Y_N, ALMEIDA_V[2],
                   device="cpu")
    rel_close(cx_np(to.V_load), cx_np(jo.V_load), FIT_REL)
    rel_close(cx_np(to.I_supply), cx_np(jo.I_supply), FIT_REL)
    assert float(to.thd_v) == pytest.approx(float(jo.thd_v), rel=FIT_REL)
