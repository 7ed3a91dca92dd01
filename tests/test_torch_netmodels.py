"""The port's network-model, converter and interop modules against the
JAX package, on the CPU: loadmodel, lineskin, longline, sequence,
converters, matpower and opendss, and the (Y, lineY, lineY_f) overrides
they build through the port's sweeps.  Both packages start from the same
arrays (hpfx_torch.convert).

Tolerances: host-side outputs (spectra, load and resistance tables, the
MATPOWER parse and network, the OpenDSS text, sequence classes) equal
exactly; admittance structures within STRUCT_TOL of their scale; float64
solves with identical iteration counts and voltages within V_TOL pu
(test_torch_sweep_api's), hpf_sequence from the cold start at H<=25
within the golden gate's 1e-8; float32 sweeps against the JAX float32
path within F32_TOL pu phasor."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpfx
import hpfx_torch as ht
from hpfx import longline as jll
from hpfx import matpower as jmp
from hpfx import opendss as jdss
from hpfx import solve as jsolve
from hpfx.network import NONLINEAR, PQ, SLACK
from hpfx_torch import longline as tll

from test_torch_continuation import pair32, scenarios32
from test_torch_foundations import (  # noqa: F401
    dev_leaves, net_leaves, one_torch_thread)
from test_torch_sweep_api import (V_TOL_COLD_H25, close, pair, phasor, same,
                                  scenarios, spread, to_np)

STRUCT_TOL = 1e-13
F32_TOL = 1e-4
ARROW = dict(solver="arrow", stable_mismatch=True)


def port_of(jnet, jdev, dtype=torch.float64):
    """The port's network and devices from the JAX package's arrays."""
    net, dev = ht.from_hpfx_arrays(net_leaves(jnet), dev_leaves(jdev),
                                   device="cpu")
    return net.to(dtype=dtype), dev.to(dtype=dtype)


def tsettings(s):
    """The port's settings of a float64 JAX ``Settings`` (dtype None is
    float64 there with x64 on)."""
    return ht.Settings(**dataclasses.asdict(s)).with_(dtype="float64")


def cx_close(t, j, tol=STRUCT_TOL):
    scale = max(1.0, float(np.abs(np.asarray(j.re)).max(initial=0)),
                float(np.abs(np.asarray(j.im)).max(initial=0)))
    close(t.re, np.asarray(j.re), tol * scale)
    close(t.im, np.asarray(j.im), tol * scale)


def triple_close(tt, jt, tol=STRUCT_TOL):
    """Two (Y, lineY, lineY_f) triples within ``tol`` of their scale."""
    cx_close(tt[0], jt[0], tol)
    for lt, lj in zip(tt[1:], jt[1:]):
        assert (lt is None) == (lj is None)
        if lt is not None:
            for k in ("Ys", "d"):
                cx_close(getattr(lt, k), getattr(lj, k), tol)
            for k in ("a_ff", "inv_tau", "shift", "f_idx", "t_idx"):
                close(getattr(lt, k), np.asarray(getattr(lj, k)), 0.0)


def exact(t, j):
    np.testing.assert_array_equal(to_np(t), np.asarray(j))


def charged(P, theta_top=0.8):
    """net2 with its lines charged so that max |θ(h_max)| = theta_top
    (validation/bench_longline.py), in both packages."""
    probe = dataclasses.replace(P.jnet,
                                line_B=jnp.ones_like(P.jnet.line_B) * 1e-3)
    th = float(np.asarray(hpfx.electrical_length(probe, P.s))[-1].max())
    b = 1e-3 * (theta_top / th) ** 2
    jnet = dataclasses.replace(P.jnet, line_B=jnp.ones_like(P.jnet.line_B) * b)
    return jnet, port_of(jnet, P.jdev)[0]


# ---------------------------------------------------------------------------
# load models, skin effect, long lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["resistive", "parallel_rl", "motor"])
def test_linear_load_admittance_exact(model):
    """The (H, n) load tables bit for bit (both built in float64 numpy),
    on the default buses and on explicit ones, and damped_structures."""
    P = pair("net3", 25, stable_mismatch=True)
    for buses in (None, [1, 2]):
        jy = hpfx.linear_load_admittance(P.jnet, P.s, model=model,
                                         buses=buses)
        ty = ht.linear_load_admittance(P.net, P.ts, model=model, buses=buses)
        exact(ty.re, jy.re)
        exact(ty.im, jy.im)
    triple_close(ht.damped_structures(P.net, P.ts, ty),
                 hpfx.damped_structures(P.jnet, P.s, jy))


def test_skin_tables_exact():
    """skin_ratio and line_resistance (a subset of lines corrected) bit for
    bit; skin_structures with a load table folded in."""
    P = pair("net2", 25, stable_mismatch=True)
    h = np.arange(1, 50)
    for model in ("exponent", "cigre_oh", "cigre_cable"):
        exact(ht.skin_ratio(h, model, alpha=0.6),
              hpfx.skin_ratio(h, model, alpha=0.6))
        exact(ht.line_resistance(P.net, P.ts, model=model, lines=[0, 2]),
              hpfx.line_resistance(P.jnet, P.s, model=model, lines=[0, 2]))
    jy = hpfx.linear_load_admittance(P.jnet, P.s, buses=[1, 2])
    ty = ht.linear_load_admittance(P.net, P.ts, buses=[1, 2])
    triple_close(ht.skin_structures(P.net, P.ts, model="cigre_cable",
                                    Y_diag=ty),
                 hpfx.skin_structures(P.jnet, P.s, model="cigre_cable",
                                      Y_diag=jy))


def test_longline_factors_match():
    """On net2 charged to |θ(25)| = 0.8: the correction factors (series
    branch outside the cut-off, the w-series inside it on the
    uncharged lines), the electrical length, and the structures with skin
    effect underneath and a load table on top."""
    P = pair("net2", 25, stable_mismatch=True)
    jnet, net = charged(P)
    for inc in (False, True):
        for jk, tk in zip(jll.longline_factors(jnet, P.s,
                                               include_fundamental=inc),
                          tll.longline_factors(net, P.ts,
                                               include_fundamental=inc)):
            cx_close(tk, jk, 1e-12)
    close(ht.electrical_length(net, P.ts),
          np.asarray(hpfx.electrical_length(jnet, P.s)), 1e-12)
    # no charging: the series branch reproduces the nominal pi exactly
    Ks, Kp = tll.longline_factors(P.net, P.ts, include_fundamental=True)
    for K in (Ks, Kp):
        exact(K.re, np.ones(K.re.shape))
        exact(K.im, np.zeros(K.im.shape))
    Rh_j = hpfx.line_resistance(jnet, P.s)
    Rh_t = ht.line_resistance(net, P.ts)
    jy = hpfx.linear_load_admittance(jnet, P.s, buses=[1, 2])
    ty = ht.linear_load_admittance(net, P.ts, buses=[1, 2])
    triple_close(ht.longline_structures(net, P.ts, Rh=Rh_t, Y_diag=ty),
                 hpfx.longline_structures(jnet, P.s, Rh=Rh_j, Y_diag=jy),
                 1e-12)


# ---------------------------------------------------------------------------
# sequence components
# ---------------------------------------------------------------------------

def test_sequence_postprocessing_matches():
    """Order classes and triplen masks exactly; the neutral current, delta
    blocking, the Fortescue transform, its inverse and the balanced phase
    expansion on seeded spectra."""
    hs = hpfx.settings_for_hmax(25).harmonics
    exact(ht.classify_orders(hs), hpfx.classify_orders(hs))
    exact(ht.triplen_mask(hs), hpfx.triplen_mask(hs))
    rng = np.random.default_rng(3)
    I = rng.uniform(0, 1, (len(hs), 5))
    for a, b in zip(ht.neutral_current(torch.tensor(I), hs),
                    hpfx.neutral_current(jnp.asarray(I), hs)):
        close(a, np.asarray(b), 1e-15)
    close(ht.delta_blocked(torch.tensor(I.T), hs, axis=1),
          np.asarray(hpfx.delta_blocked(jnp.asarray(I.T), hs, axis=1)), 0.0)
    ph = [rng.normal(size=(len(hs), 5)) + 1j * rng.normal(size=(len(hs), 5))
          for _ in range(3)]
    tcx = lambda z: ht.Cx(torch.tensor(z.real), torch.tensor(z.imag))
    jcx = lambda z: hpfx.Cx(jnp.asarray(z.real), jnp.asarray(z.imag))
    ts = ht.sequence_components(*map(tcx, ph))
    js = hpfx.sequence_components(*map(jcx, ph))
    for a, b in zip(ts, js):
        cx_close(a, b, 1e-15)
    for a, b in zip(ht.phase_components(ts), hpfx.phase_components(js)):
        cx_close(a, b, 1e-15)
    Vm, Va = np.abs(ph[0]), np.angle(ph[0])
    for a, b in zip(ht.balanced_phases(torch.tensor(Vm), torch.tensor(Va),
                                       hs),
                    hpfx.balanced_phases(jnp.asarray(Vm), jnp.asarray(Va),
                                         hs)):
        cx_close(a, b, 1e-15)


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "dense"])
def test_sequence_structures_match(stable):
    """The zero-sequence companion (scaled lines, an ungrounded shunt) and
    the per-order blend with a blocked line, a grounded neutral and a load
    table; the line structures None without the stable mismatch."""
    P = pair("net3", 25, stable_mismatch=stable)
    kw = dict(r0_scale=2.5, x0_scale=3.0, b0_scale=0.6,
              ungrounded_shunts=(2,))
    jn0 = hpfx.zero_sequence_network(P.jnet, **kw)
    tn0 = ht.zero_sequence_network(P.net, **kw)
    for f in ("line_R", "line_X", "line_B", "bus_Xsh"):
        exact(getattr(tn0, f), getattr(jn0, f))
    jy = hpfx.linear_load_admittance(P.jnet, P.s, buses=[1, 2])
    ty = ht.linear_load_admittance(P.net, P.ts, buses=[1, 2])
    skw = dict(blocked=(1,), bus_Xg={1: 0.1, 3: 0.05})
    triple_close(ht.sequence_structures(P.net, P.ts, tn0, Y_diag=ty, **skw),
                 hpfx.sequence_structures(P.jnet, P.s, jn0, Y_diag=jy,
                                          **skw))
    triple_close(ht.sequence_structures(P.net, P.ts, r0_scale=2.0),
                 hpfx.sequence_structures(P.jnet, P.s, r0_scale=2.0))


@pytest.mark.parametrize("coupled", [True, False],
                         ids=["coupled", "uncoupled"])
def test_delta_device_set_match(coupled):
    P = pair("net1", 25, coupled=coupled)
    jd = hpfx.delta_device_set(P.jdev, P.s, (0, 3))
    td = ht.delta_device_set(P.dev, P.ts, (0, 3))
    exact(td.I_N.re, jd.I_N.re)
    exact(td.Y_N.im, jd.Y_N.im)


@pytest.mark.parametrize("name", ["net2", "net3"])
def test_hpf_sequence_matches(name):
    """hpf_sequence at H<=25 in float64 from the cold start: identical
    iterations and voltages within the golden gate's 1e-8, with a blocked
    line and a grounded neutral."""
    P = pair(name, 25, stable_mismatch=True)
    kw = dict(r0_scale=2.5, x0_scale=3.0, blocked=(1,), bus_Xg={1: 0.1})
    rj = hpfx.hpf_sequence(P.jnet, P.jdev, P.s, **kw)
    rt = ht.hpf_sequence(P.net, P.dev, P.ts, **kw)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.n_iter) == int(rj.n_iter)
    close(rt.V_m, rj.V_m, V_TOL_COLD_H25)
    close(phasor(rt), phasor(rj), V_TOL_COLD_H25)


def _overrides(P, jnet, net):
    """Each study's (Y, lineY, lineY_f) in both packages."""
    jy = hpfx.linear_load_admittance(jnet, P.s, buses=[1, 2])
    ty = ht.linear_load_admittance(net, P.ts, buses=[1, 2])
    return {
        "damped": (hpfx.damped_structures(jnet, P.s, jy),
                   ht.damped_structures(net, P.ts, ty)),
        "seqaware": (hpfx.sequence_structures(jnet, P.s, r0_scale=2.5,
                                              x0_scale=3.0, bus_Xg={1: 0.1}),
                     ht.sequence_structures(net, P.ts, r0_scale=2.5,
                                            x0_scale=3.0, bus_Xg={1: 0.1})),
        "longline": (hpfx.longline_structures(jnet, P.s),
                     ht.longline_structures(net, P.ts)),
        "skin": (hpfx.skin_structures(jnet, P.s),
                 ht.skin_structures(net, P.ts)),
    }


@pytest.mark.parametrize("variant", ["damped", "seqaware", "longline",
                                     "skin"])
def test_override_sweeps_match(variant):
    """Each study's (Y, lineY, lineY_f) through the port's lane-major
    hpf_sweep (net2 H<=5 B=8, the longline variant on the charged net2)
    in float64: identical counts and flags, voltages within V_TOL."""
    P = pair("net2", 5, **ARROW)
    jnet, net = charged(P) if variant == "longline" else (P.jnet, P.net)
    jY, tY = _overrides(P, jnet, net)[variant]
    sj, st = scenarios(*spread(8, seed=21)[:3])
    same(jsolve.hpf_sweep(jnet, P.jdev, P.s, sj, Y=jY),
         ht.hpf_sweep(net, P.dev, P.ts, st, Y=tY))


def test_override_adaptive_f32():
    """The seqaware override through hpf_sweep_adaptive in float32 (the
    phase-19 schedule, cut to net2 H<=5 B=16): flags identical, phasors
    within F32_TOL of the JAX float32 path."""
    s, jnet, jdev, ts, net, dev = pair32("net2", 5, solver="arrow")
    jY = hpfx.sequence_structures(jnet, s, r0_scale=2.5, x0_scale=3.0,
                                  bus_Xg={1: 0.1})
    tY = ht.sequence_structures(net, ts, r0_scale=2.5, x0_scale=3.0,
                                bus_Xg={1: 0.1})
    sj, st = scenarios32(*spread(16, seed=22)[:3])
    rj = jsolve.hpf_sweep_adaptive(jnet, jdev, s, sj, Y=jY)
    rt = ht.hpf_sweep_adaptive(net, dev, ts, st, Y=tY)
    np.testing.assert_array_equal(to_np(rt.converged), to_np(rj.converged))
    assert to_np(rt.converged).all()
    close(phasor(rt), phasor(rj), F32_TOL)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

TABLE = {1: (100.0, 0.0), 5: (20.0, -30.0), 7: (14.0, 45.0), 11: (9.0, 10.0)}


def test_converter_spectra_exact():
    hs = hpfx.settings_for_hmax(49).harmonics
    for a, m in ((0.0, 0.0), (0.35, 0.17), (1.1, 0.4)):
        exact(ht.six_pulse_spectrum(hs, 0.3, a, m),
              hpfx.six_pulse_spectrum(hs, 0.3, a, m))
        exact(ht.twelve_pulse_spectrum(hs, 0.7, a, m),
              hpfx.twelve_pulse_spectrum(hs, 0.7, a, m))
    for percent in (True, False):
        exact(ht.table_spectrum(hs, TABLE, I1=0.5, percent=percent),
              hpfx.table_spectrum(hs, TABLE, I1=0.5, percent=percent))
    spec = hpfx.six_pulse_spectrum(hs, 1.0, 0.2, 0.1)
    for a, b in zip(ht.synth_waveform(spec, hs, n=512),
                    hpfx.synth_waveform(spec, hs, n=512)):
        exact(a, b)


def test_converter_device_set_and_warm_start():
    """converter_device_set rows bit for bit (six-pulse, twelve-pulse, a
    table, a raw spectrum; the leak floor), the exact linear seed, and hpf
    from it in float64 with identical iterations."""
    P = pair("net1", 25, coupled=False)
    hs = P.s.harmonics
    entries = [{"kind": "six_pulse", "I1": 0.3, "alpha": np.deg2rad(20.0),
                "mu": np.deg2rad(10.0)},
               {"kind": "twelve_pulse", "I1": 0.2, "alpha": 0.1},
               {"kind": "table", "table": TABLE, "I1": 0.25},
               hpfx.six_pulse_spectrum(hs, 0.1, 0.3, 0.05)] \
        + [{"kind": "six_pulse", "I1": 0.15}] * (P.jnet.n_nonlinear - 4)
    jd = hpfx.converter_device_set(P.jnet, P.s, entries)
    td = ht.converter_device_set(P.net, P.ts, entries)
    for k in ("I_N", "Y_N"):
        exact(getattr(td, k).re, getattr(jd, k).re)
        exact(getattr(td, k).im, getattr(jd, k).im)
    jv = hpfx.converter_warm_start(P.jnet, P.s, jd)
    tv = ht.converter_warm_start(P.net, P.ts, td)
    close(tv[0], np.asarray(jv[0]), 1e-12)
    close(tv[1], np.asarray(jv[1]), 1e-9)
    rj = hpfx.hpf(P.jnet, jd, P.s, V0=jv)
    rt = ht.hpf(P.net, td, P.ts, V0=tv)
    assert bool(rt.converged) and int(rt.n_iter) == int(rj.n_iter)
    close(rt.V_m, rj.V_m, V_TOL_COLD_H25)
    close(phasor(rt), phasor(rj), V_TOL_COLD_H25)


def test_notch_analysis_match():
    P = pair("net1", 5, coupled=False)
    for obs, cls in ((None, "general"), (3, "special"), (12, "dedicated")):
        j = hpfx.notch_analysis(P.jnet, P.s, 10, alpha=0.4, mu=0.2,
                                observe_bus=obs, v_class=cls)
        t = ht.notch_analysis(P.net, P.ts, 10, alpha=0.4, mu=0.2,
                              observe_bus=obs, v_class=cls)
        assert t.compliant == j.compliant
        np.testing.assert_allclose(t[:6], j[:6], rtol=1e-12)


# ---------------------------------------------------------------------------
# MATPOWER and OpenDSS
# ---------------------------------------------------------------------------

CASE = """\
function mpc = case5
% a 5-bus case: a generator at a PV bus, shunts, a tap and a shift,
% an out-of-service generator and branch
mpc.version = '2';
mpc.baseMVA = 100;
mpc.bus = [
	4	1	25	10	0	0	1	1	0	0.4	1	1.1	0.9;
	1	3	0	0	0	0	1	1	0	0.4	1	1.1	0.9;
	3	1	10	10	0	4	1	1	0	0.4	1	1.1	0.9;
	2	2	5	0	0	0	1	1	0	0.4	1	1.1	0.9;
	5	1	8	3	0	0	1	1	0	0.4	1	1.1	0.9;
];
mpc.gen = [
	2	25	0	300	-300	1.02	100	1	250	10;
	2	0	0	300	-300	1	100	0	250	10;
];
mpc.branch = [
	1	2	0.003	0.006	0.002	250	250	250	0	0	1;
	2	3	0.006	0.024	0	250	250	250	1.05	2.5	1;
	3	4	0.003	0.006	0	250	250	250	0	0	1;
	4	5	0.004	0.010	0.001	250	250	250	0	0	1;
	1	4	0.05	0.20	0	250	250	250	0	0	0;
];
"""


def test_matpower_matches(tmp_path):
    """The parse bit for bit, the loaded network's arrays and metadata
    bit for bit, and the same warnings."""
    path = tmp_path / "case5.m"
    path.write_text(CASE)
    a, b = ht.parse_matpower(str(path)), jmp.parse_matpower(str(path))
    assert a.keys() == b.keys()
    for k in a:
        exact(a[k], b[k])
    s = hpfx.settings_for_hmax(5, coupled=True)
    kw = dict(nonlinear={4: "SMPS", 5: "SMPS"}, slack_xsh=0.01)
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jnet = hpfx.load_matpower(str(path), s, **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        tnet = ht.load_matpower(str(path), tsettings(s), device="cpu", **kw)
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert len(wt) == 2
    for f in dataclasses.fields(jnet):
        x, y = getattr(tnet, f.name), getattr(jnet, f.name)
        if isinstance(x, torch.Tensor):
            exact(x, y)
        else:
            assert x == y, f.name


def _trafo_case(s):
    """A three-bus case with a tapped, phase-shifting branch
    (tests/test_opendss.py's)."""
    kw = dict(bus_types=(SLACK, PQ, NONLINEAR),
              components=("generator", "lin_load", "SMPS"),
              P=[0, 100, 250], Q=[0, 50, 100], X_sh=[0.005, 0, 0],
              line_from=[0, 1], line_to=[1, 2], R=[0.5, 1.0], X=[2.0, 4.0],
              tau=[1.05, 1.0], phase_shift=[30.0, 0.0], per_unit=False)
    jnet = hpfx.network_from_arrays(settings=s, **kw)
    return jnet, hpfx.load_device_set(jnet, s)


@pytest.mark.parametrize("case", ["net2", "converter", "trafo"])
def test_opendss_text_identical(case, tmp_path):
    """export_opendss_case writes the JAX package's text, byte for byte,
    and the same element count; device_spectra_at_nominal bit for bit."""
    if case == "trafo":
        s = hpfx.settings_for_hmax(9, coupled=True)
        jnet, jdev = _trafo_case(s)
        net, dev = port_of(jnet, jdev)
    else:
        P = pair("net2", 25, coupled=case == "net2")
        s, jnet, jdev, net, dev = P.s, P.jnet, P.jdev, P.net, P.dev
        if case == "converter":
            entries = [{"kind": "six_pulse", "I1": 0.3, "alpha": 0.35}]
            jdev = hpfx.converter_device_set(jnet, s, entries)
            dev = ht.converter_device_set(net, tsettings(s), entries)
    ts = tsettings(s)
    exact(ht.device_spectra_at_nominal(dev, ts),
          jdss.device_spectra_at_nominal(jdev, s))
    pj, pt = tmp_path / "j.dss", tmp_path / "t.dss"
    nj = hpfx.export_opendss_case(jnet, jdev, s, str(pj), circuit_name="c")
    nt = ht.export_opendss_case(net, dev, ts, str(pt), circuit_name="c")
    assert nt == nj
    assert pt.read_text() == pj.read_text()
