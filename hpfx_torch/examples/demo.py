"""End-to-end hpfx_torch demo: every layer of the pipeline in one script,
the port of the repository's ``examples_demo.py`` (the same 29 sections,
on the port's functions).

    python -m hpfx_torch.examples.demo                 # the CUDA card, float32
    python -m hpfx_torch.examples.demo --device cpu    # the CPU, float64

Sections 12 and 13 run the port's Adam (:mod:`hpfx_torch.optim`) where
the JAX demo runs optax's.  Covers, in order: device characterization and
Norton fit, the net2 solve, a batched hosting-capacity sweep with
sensitivities, penetration sensitivity, Kron reduction, a device-mix
Monte-Carlo on net4, the continuation sweep, a transformer feeder, line
sensitivities, the impedance scan, emission allocation and a tuned
filter, tap and filter optimization, line flows and IEEE-519, source
estimation, hosting capacity, background distortion, percentile and
time-series studies, N-1 screens, load damping and the sequence-aware
solve, resonance modes, unbalanced three-phase, IEEE 1459 and waveshape,
long lines, analytic converters, the active filter, the exact-linear warm
start, a batched background study and the (outage x scenario) cross.
"""
import argparse
import dataclasses
import os

import numpy as np
import torch

import hpfx_torch as ht
from hpfx_torch._device import resolve_device

DATA = ht.DATA_DIR


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def main(device=None):
    dv = resolve_device(device)
    dtype = "float64" if dv.type == "cpu" else "float32"
    S = lambda h, **kw: ht.settings_for_hmax(h, dtype=dtype, **kw)
    load = lambda name, s: ht.load_network(
        os.path.join(DATA, f"{name}_buses.csv"),
        os.path.join(DATA, f"{name}_lines.csv"), s, device=dv)

    # -- 1. characterize a rectifier and fit its Norton equivalent --------
    from hpfx_torch.simulate import (SweepProtocol, characterize_rectifier,
                                     smps_params)
    proto = SweepProtocol(harm_freqs=(150.0, 250.0, 350.0, 450.0))
    ms = characterize_rectifier(smps_params(), proto, device=dv)
    fit = ht.fit_norton_from_measurements(ms)
    print(f"[1] NE fit: self-test uncoupled={fit.err_uncoupled:.1e} "
          f"coupled={fit.err_coupled:.1e} passed={fit.passed}")

    # -- 2. harmonic power flow on net2 -----------------------------------
    s = S(25, coupled=True)
    rd = s.real_dtype
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=rd, device=dv)
    net = load("net2", s)
    dev = ht.load_device_set(net, s)
    res = ht.hpf(net, dev, s)
    rep = ht.report(res, s)
    print(f"[2] net2 H<=25 coupled: {rep.n_iter_harm} NR iterations, "
          f"err={rep.err_harm:.2e}, THD_F per bus="
          f"{np.round(_np(rep.thd.THD_F), 4)}")

    # -- 3. hosting-capacity sweep ----------------------------------------
    B = 512
    rng = np.random.default_rng(0)
    scen = ht.Scenarios(
        p_scale=T(rng.uniform(0.9, 1.1, B)),
        q_scale=T(rng.uniform(0.9, 1.1, B)),
        injection_scale=T(rng.uniform(0.2, 1.2, B)))
    summary = ht.hosting_capacity_sweep(net, dev, s, scen, thd_limit=0.5)
    print(f"[3] sweep B={B}: conv="
          f"{float(summary.converged.float().mean()):.3f}, "
          f"frac THD>0.5: {float(summary.frac_over_limit):.3f}")
    sweep_res = ht.hpf_sweep(net, dev, s, scen)
    ssens = ht.sweep_sensitivity(net, dev, s, sweep_res, scen)
    g = _np(ssens.grad.injection_scale)[_np(sweep_res.converged)]
    print(f"    per-scenario d(maxTHD)/d(penetration): "
          f"min={g.min():+.3f} median={np.median(g):+.3f} max={g.max():+.3f}")

    # -- 4. sensitivity of worst-bus THD to penetration -------------------
    sens = ht.injection_sensitivity(net, dev, s, res)
    print(f"[4] d(maxTHD)/d(penetration) at nominal: "
          f"{float(sens.grad):+.4f} (THD={float(sens.value):.4f})")

    # -- 5. Kron-reduce the passive bus -----------------------------------
    red = ht.kron_reduce(net, s)
    res_r = ht.hpf(red.net, dev, s, Y=red.Y)
    V_m, _ = ht.recover_voltages(red, res_r, net.n)
    dthd = np.abs(_np(ht.get_thd(V_m).THD_F) - _np(rep.thd.THD_F)).max()
    print(f"[5] Kron-reduced ({net.n}->{red.net.n} buses): THD matches "
          f"full solve to {dthd:.1e}")

    # -- 6. device-mix Monte-Carlo on net4 --------------------------------
    s4 = S(9, coupled=True, solver="arrow")
    net4 = load("net4", s4)
    lib = ht.load_device_library(("SMPS", "ev_1", "ev_4"), s4, device=dv)
    Bm, n_nl = 64, net4.n_nonlinear
    w = np.zeros((Bm, n_nl, lib.n_types))
    t = rng.integers(0, lib.n_types, (Bm, n_nl))
    cnt = rng.integers(0, 3, (Bm, n_nl))
    w[np.arange(Bm)[:, None], np.arange(n_nl)[None, :], t] = cnt
    ones = torch.ones(Bm, dtype=rd, device=dv)
    scen_m = ht.Scenarios(p_scale=ones, q_scale=ones, device_mix=T(w))
    summ = ht.hosting_capacity_sweep(net4, lib, s4, scen_m, thd_limit=0.08)
    print(f"[6] device-mix sweep B={Bm} ({lib.n_types} types x {n_nl} buses,"
          f" 0-2 units each): conv="
          f"{float(summ.converged.float().mean()):.3f}, "
          f"frac THD>8%: {float(summ.frac_over_limit):.3f}")
    # marginal THD impact of one more device of each type at each bus
    w0 = T(np.ones((n_nl, lib.n_types)))
    one1 = torch.ones(1, dtype=rd, device=dv)
    scen1 = ht.Scenarios(p_scale=one1, q_scale=one1, device_mix=w0[None])
    r1 = ht.hpf_sweep(net4, lib, s4, scen1)
    one = ht.HPFResult(V_m=r1.V_m[0], V_a=r1.V_a[0], err=r1.err[0],
                       n_iter=r1.n_iter[0], err_hist=r1.err_hist[0],
                       converged=r1.converged[0])
    msens = ht.mix_sensitivity(net4, lib, s4, one, w0)
    mg = _np(msens.grad)
    worst = np.unravel_index(np.argmax(mg), mg.shape)
    print(f"    d(maxTHD)/d(one more {lib.names[worst[1]]} at bus "
          f"{net4.m + worst[0] + 1}) = {float(mg[worst]):+.4f} "
          f"(the worst marginal addition)")

    # -- 7. warm-start continuation sweep ---------------------------------
    Bc = 64
    onesc = torch.ones(Bc, dtype=rd, device=dv)
    scen_c = ht.Scenarios(p_scale=onesc, q_scale=onesc,
                          injection_scale=T(np.linspace(0.3, 1.5, Bc)))
    plain = ht.hpf_sweep(net, dev, s, scen_c)
    cont = ht.hpf_sweep_continuation(net, dev, s, scen_c, n_stages=4)
    print(f"[7] continuation sweep B={Bc}: mean NR trips "
          f"{float(plain.n_iter.double().mean()):.1f} -> "
          f"{float(cont.n_iter.double().mean()):.1f} at conv "
          f"{float(cont.converged.double().mean()):.3f}")

    # -- 8. transformer feeder end-to-end ---------------------------------
    from hpfx_torch.network import NONLINEAR, PQ, SLACK
    st = S(9, coupled=True)
    net_t = ht.network_from_arrays(
        bus_types=(SLACK, PQ, NONLINEAR),
        components=("generator", "lin_load", "SMPS"),
        P=[0, 100, 250], Q=[0, 50, 100], X_sh=[0.005, 0, 0],
        line_from=[0, 1], line_to=[1, 2],
        R=[0.5, 1.0], X=[2.0, 4.0],
        tau=[1.05, 1.0], phase_shift=[30.0, 0.0],
        settings=st, per_unit=False, device=dv)
    dev_t = ht.load_device_set(net_t, st)
    res_t = ht.hpf(net_t, dev_t, st)
    print(f"[8] trafo feeder (tau=1.05, 30deg): converged="
          f"{bool(res_t.converged)} in {int(res_t.n_iter)} iters, "
          f"|V1|={float(res_t.V_m[0, 1]):.4f} "
          f"ang={np.degrees(float(res_t.V_a[0, 1])):.1f}deg")

    # -- 9. line-parameter sensitivities on the trafo feeder --------------
    lsens = ht.line_sensitivity(
        net_t, dev_t, st, res_t,
        line_params=ht.LineParams(z_scale=torch.ones(
            net_t.n_lines, dtype=st.real_dtype, device=dv)))
    print(f"[9] d(maxTHD)/d(trafo tap)={float(lsens.grad.tau[0]):+.4f}, "
          f"d/d(line-1 |Z| scale)={float(lsens.grad.z_scale[1]):+.4f} "
          f"(THD={float(lsens.value):.4f})")

    # -- 10. impedance scan: which orders does the grid amplify? ----------
    zmag = ht.driving_point_impedance(net, s)
    is_peak, worst_h, worst_z = ht.resonance_peaks(zmag, s)
    wb = int(np.argmax(_np(worst_z)))
    print(f"[10] impedance scan net2: bus {wb} peaks at h="
          f"{int(worst_h[wb])} (|Z|={float(worst_z[wb]):.3f} pu; "
          f"{int(_np(is_peak).sum())} local peaks across "
          f"{zmag.shape[1]} buses x {zmag.shape[0]} harmonics)")

    # -- 11. emission allocation + dense scan + tuned filter in service ---
    contrib = ht.distortion_contributions(net, dev, s)
    cmag = np.abs(_np(contrib.re) + 1j * _np(contrib.im))
    shares = cmag[1:, wb].sum(axis=0)             # per-device share at wb
    top_dev = int(np.argmax(shares))
    grid = np.round(np.arange(2.0, float(s.harmonics[-1]) + 0.25, 0.25), 4)
    zdense = _np(ht.frequency_scan(net, s, grid, devices=dev))
    h_res = float(grid[int(np.argmax(zdense[:, wb]))])
    Yf = ht.install_shunt(
        ht.build_ybus(net, s), wb,
        ht.tuned_filter_admittance(s, h_res, x_cap=0.05, device=dv))
    res_f = ht.hpf(net, dev, s, Y=Yf)
    thd_base = float(ht.get_thd(res.V_m).THD_F.max())
    thd_filt = float(ht.get_thd(res_f.V_m).THD_F.max())
    print(f"[11] emission allocation at bus {wb}: device {top_dev} "
          f"contributes {100 * shares[top_dev] / shares.sum():.0f}%; "
          f"operational resonance at h={h_res:.2f} (dense scan); "
          f"single-tuned filter there: maxTHD {thd_base:.4f} -> "
          f"{thd_filt:.4f} (converged={bool(res_f.converged)})")

    # -- 12. gradient-based tap optimization on the trafo feeder ----------
    opt = ht.optimize_line_params(
        net_t, dev_t, st, vary=("tau",), fixed_lines=[1],
        steps=20, learning_rate=0.01)
    print(f"[12] tap optimization (adam on IFT gradients, 20 steps): "
          f"maxTHD {opt.value0:.4f} -> {opt.value:.4f} at tau="
          f"{float(opt.params.tau[0]):.3f} ({opt.n_solves} HPF solves)")

    # -- 13. gradient-tuned filter: stage 11's hand-sized design, optimized
    fopt = ht.optimize_filter(net, dev, s, bus=wb, h_tune0=h_res,
                              x_cap0=0.05, steps=15, learning_rate=0.05)
    print(f"[13] filter optimization at bus {wb} (IFT gradients over "
          f"h_tune/x_cap, 15 steps): maxTHD {fopt.value0:.4f} -> "
          f"{fopt.value:.4f} at h_tune="
          f"{float(fopt.params.h_tune):.2f}, x_cap="
          f"{float(fopt.params.x_cap):.3f} "
          f"({fopt.n_solves} HPF solves)")

    # -- 14. line flows + IEEE-519: what the filter trade actually costs
    fl0 = ht.line_flows(net, s, res.V_m, res.V_a)
    res_opt = ht.hpf(net, dev, s, Y=fopt.Y)
    fl1 = ht.line_flows(net, s, res_opt.V_m, res_opt.V_a)
    rep519 = ht.check_ieee519(res_opt, s)
    h0 = float(fl0.loss[1:].sum())
    h1 = float(fl1.loss[1:].sum())
    print(f"[14] flows: harmonic line losses {h0:.4f} -> {h1:.4f} pu "
          f"(the filter absorbs harmonics THROUGH the feeder); "
          f"IEEE-519 (<=1 kV): "
          f"{int(_np(rep519.compliant).sum())}/{net.n} buses "
          f"compliant, worst individual "
          f"{float(rep519.worst_ratio.max()):.1f}% "
          f"(limit {rep519.limit_individual}%)")

    # -- 15. inverse problem: localize the sources from meter readings --
    true_sc = np.array([0.85])                   # net2 has one device
    res_m = ht.hpf(net, dev.scale(T(true_sc)), s)
    est = ht.estimate_injections(net, dev, s, res_m.V_m,
                                 buses=[1], scales0=1.0)
    print(f"[15] source estimation from bus-1 meter only: true scale "
          f"{true_sc[0]:.2f}, fitted "
          f"{float(_np(est.scales)[0]):.4f} "
          f"(misfit {est.misfit0:.1e} -> {est.misfit:.1e}, "
          f"{est.n_solves} solves)")

    # -- 16. hosting capacity: how much can the devices grow? ----------
    # net2's worst Monte-Carlo draw sits at THD_F ~0.66 already at nominal
    # (the shipped feeder is heavily distorted), so the demo asks how far
    # penetration can grow before the worst draw crosses 0.8.
    scen = ht.monte_carlo_scenarios(0, 16, net, s, device=dv)
    cap = ht.find_hosting_capacity(net, dev, s, scen, confidence=1.0,
                                   thd_limit=0.8, hi=8.0, tol=0.125)
    if cap.feasible:
        print(f"[16] hosting capacity (B=16 Monte-Carlo draws, worst-bus "
              f"THD_F <= 0.8 at confidence 1.0): "
              f"{'>=' if cap.bracket_open else ''}{cap.level:.2f}x nominal "
              f"({len(cap.levels)} bisection probes, compliant fraction "
              f"{cap.frac_at_level:.2f})")
    else:
        print(f"[16] hosting capacity: base system already non-compliant "
              f"(compliant fraction {cap.frac_at_level:.2f} at nominal)")

    # -- 17. background grid distortion (upstream spectrum) -------------
    I_bg = ht.background_from_harmonics(net, s, {5: (0.02, 0.0),
                                                 7: (0.01, 0.5)})
    res_bg = ht.hpf(net, dev, s, I_bg=I_bg)
    thd_bg = _np(ht.get_thd(res_bg.V_m).THD_F)
    print(f"[17] background distortion (2% 5th + 1% 7th behind the grid "
          f"X_sh): THD_F per bus {np.round(_np(rep.thd.THD_F), 4)}"
          f" -> {np.round(thd_bg, 4)} (converged={bool(res_bg.converged)})")

    # -- 18. percentile assessment + quasi-static time series ------------
    scen_q = ht.monte_carlo_scenarios(1, 64, net, s, inj_spread=0.3,
                                      device=dv)
    qa = ht.assess_quantiles(net, dev, s, scen_q,
                             quantiles=(0.5, 0.95, 0.99))
    pl = ht.check_planning_levels(qa, {5: 5.0, 7: 4.0, 11: 3.0},
                                  default_pct=3.0)
    print(f"[18] percentile assessment (B=64 draws): worst bus "
          f"{qa.worst_bus} THD p50/p95/p99 = "
          f"{float(qa.thd_q[0, qa.worst_bus]):.3f}/"
          f"{float(qa.thd_q[1, qa.worst_bus]):.3f}/"
          f"{float(qa.thd_q[2, qa.worst_bus]):.3f}; planning levels "
          f"(IEC 61000-3-6 shape): compliant={pl.compliant}, binding "
          f"h={pl.binding_order} at bus {pl.binding_bus}")
    ts = ht.run_timeseries(net, dev, s, ht.daily_profile(48, device=dv),
                           chunk=24)
    pc = ht.percentile_compliance(ts, s)
    print(f"     daily profile (48 steps): p95 worst-bus THD "
          f"{float(pc.thd_p.max()):.2f}% vs limit "
          f"{pc.limit_thd}% -> compliant={pc.compliant}")

    # -- 19. N-1 contingency screens on the meshed net1 feeder -----------
    s1 = S(5, coupled=False)
    net1 = load("net1", s1)
    dev1 = ht.load_device_set(net1, s1)
    repc = ht.screen_line_outages(net1, dev1, s1, outages=[0, 20, 21, 22])
    top = repc.ranking[0]
    print(f"[19] N-1 line screen (net1, 4 outages, one batched solve): "
          f"worst is line {repc.outages[top]} — worst-bus THD "
          f"{float(repc.base_thd.max()):.3f} -> "
          f"{float(repc.worst_thd[top]):.3f}")
    shift = ht.outage_impedance_shift(net1, dev1, s1, outages=[0, 22])
    st0 = shift.ranking[0]
    print(f"     resonance shift: losing line {shift.outages[st0]} "
          f"amplifies |Z(h={int(shift.shift_order[st0])})| at bus "
          f"{int(shift.shift_bus[st0])} by "
          f"{float(shift.amplification[st0]):.1f}x")

    # -- 20. load damping + sequence-aware triplen solve ------------------
    # (net1, uncoupled: harmonic orders solve independently, so the
    # sequence-network effect is visible as a pure triplen shift)
    base20 = ht.hpf(net1, dev1, s1)
    s25 = S(25, coupled=False)   # scan depth where net1's X_sh resonates
    yd25 = ht.linear_load_admittance(net1, s25)
    z_open = _np(ht.driving_point_impedance(net1, s25))
    z_damp = _np(ht.driving_point_impedance(
        net1, s25, Y=ht.fold_ydiag(ht.build_ybus(net1, s25), yd25)))
    k = int(np.argmax(z_open[1:]))  # worst harmonic driving-point |Z|
    print(f"[20] parallel-RL load damping (net1 H<=25, "
          f"{int((net1.bus_P[:net1.m] > 0).sum())} damped "
          f"buses): worst harmonic |Z_kk| {float(z_open[1:].flat[k]):.2f} "
          f"-> {float(z_damp[1:].flat[k]):.2f} pu (open-circuit loads "
          f"overstate the peak)")
    seq = ht.hpf_sequence(net1, dev1, s1, r0_scale=2.5, x0_scale=3.0,
                          bus_Xg={1: 0.1})
    tri = _np(ht.triplen_mask(s1.harmonics))
    dvs = np.abs(_np(seq.V_m) - _np(base20.V_m))
    print(f"     sequence-aware solve (triplens on the zero-sequence "
          f"network): max |dV| triplen {float(dvs[tri].max()):.2e} vs "
          f"non-triplen {float(dvs[~tri].max()):.2e} (uncoupled: exact 0)")

    # -- 21. resonance mode analysis: mechanism behind the |Z| peaks ------
    grid = tuple(np.round(np.arange(2.0, 25.01, 0.25), 3))
    mscan = ht.modal_scan(net, s, h_grid=grid, devices=dev)
    m_peak, h_res, bus_res = ht.modal_peaks(mscan)
    ki = int(np.argmax(_np(mscan.z_modal)))
    lam, msens = ht.eigen_sensitivity(net, s, float(h_res), devices=dev)
    dzx = _np(msens["line_X"]["dz_modal"])
    kl = int(np.argmax(np.abs(dzx)))
    print(f"[21] resonance modes net2 (operational, 0.25-step grid): "
          f"dominant mode at order {float(h_res):g}, z_modal="
          f"{float(mscan.z_modal[ki]):.4f} pu, critical bus "
          f"{int(bus_res)} (participation "
          f"{float(mscan.participation[ki, int(bus_res)]):.3f}); "
          f"strongest retuning knob: line-{kl} X "
          f"(dz_modal/dX={dzx[kl]:+.2f})")

    # -- 22. unbalanced three-phase penetration ---------------------------
    # phase a carries 30% more converter load; device 0 is 3-wire (delta)
    s22 = S(13, coupled=False)
    dev22 = ht.load_device_set(net, s22)
    mag = np.ones((dev22.n_devices, 3))
    mag[:, 0] = 1.3
    res22 = ht.solve_unbalanced(net, dev22, s22, r0_scale=2.5,
                                x0_scale=3.0, bus_Xg={1: 0.1},
                                mag=mag, delta=[0])
    u0, u2 = ht.unbalance_factors(res22)
    print(f"[22] unbalanced 3-phase penetration (net2, phase a +30%, "
          f"delta device): worst foreign-sequence leakage fractions "
          f"{float(u0[1:].max()):.3f} / {float(u2[1:].max()):.3f} of total "
          f"(balanced theory calls both 0)")

    # -- 23. metering-point view: IEEE 1459 + waveshape --------------------
    pi = ht.line_power_indices(net, s, res.V_m, res.V_a, side="from")
    k = int(np.argmax(_np(pi.thd_i)))
    wm = ht.waveform_metrics(res.V_m, res.V_a, s.harmonics)
    print(f"[23] IEEE 1459 at line {k} (net2's worst-TDD terminal): "
          f"S={float(pi.S[k]):.3f} = "
          f"sqrt(S1²+D_I²+D_V²+S_H²), true pf {float(pi.pf[k]):+.3f} vs "
          f"displacement {float(pi.dpf[k]):+.3f}; worst bus crest factor "
          f"{float(wm.crest.max()):.3f} (clean sine: 1.414)")

    # -- 24. long lines: electrical length grows with harmonic order ------
    net24 = dataclasses.replace(net, line_B=torch.full_like(net.line_B,
                                                            4.1e-2))
    th24 = _np(ht.electrical_length(net24, s))
    res24n = ht.hpf(net24, dev, s)
    res24l = ht.hpf(net24, dev, s, Y=ht.longline_structures(net24, s))
    print(f"[24] long-line correction (charged net2, |θ| up to "
          f"{th24[-1].max():.2f} rad at h=25): nominal-pi worst THD "
          f"{float(ht.get_thd(res24n.V_m).THD_F.max()):.4f}"
          f" vs exact-pi "
          f"{float(ht.get_thd(res24l.V_m).THD_F.max()):.4f}"
          f" — the short-line premise fails exactly where the study "
          f"looks")

    # -- 25. analytic converter devices (no NE data needed) ---------------
    s25 = S(25, coupled=False)
    dev6 = ht.converter_device_set(
        net, s25, [{"kind": "six_pulse", "I1": 0.3,
                    "alpha": np.deg2rad(20.0), "mu": np.deg2rad(10.0)}])
    v06 = ht.converter_warm_start(net, s25, dev6)
    r6 = ht.hpf(net, dev6, s25, V0=v06)
    dev12 = ht.converter_device_set(
        net, s25, [{"kind": "twelve_pulse", "I1": 0.3,
                    "alpha": np.deg2rad(20.0), "mu": np.deg2rad(10.0)}])
    r12 = ht.hpf(net, dev12, s25,
                 V0=ht.converter_warm_start(net, s25, dev12))
    t6 = float(ht.get_thd(r6.V_m).THD_F.max())
    t12 = float(ht.get_thd(r12.V_m).THD_F.max())
    print(f"[25] textbook converters on net2's NL bus (closed-form "
          f"spectra, exact linear warm start, {int(r6.n_iter)} NR "
          f"iters): 6-pulse worst THD {t6:.4f} -> 12-pulse {t12:.4f} "
          f"(the Y/Δ pair cancels 5,7,17,19)")

    # -- 26. active filter sizing ------------------------------------------
    af = ht.size_active_filter(net, dev, s, bus=3)
    print(f"[26] active filter at bus 3: THD {af.thd_before:.4f} -> "
          f"{af.thd_after:.4f} with a {af.rating_rms:.1f} pu rms "
          f"compensator ({af.n_solves} HPF solves; complex-target LM on "
          f"the IFT Jacobian — per-order impedance correction diverges "
          f"on coupled NEs)")

    # -- 27. exact-linear Norton warm start ---------------------------------
    lin8 = lambda a, b: T(np.linspace(a, b, 8))
    sc27 = ht.Scenarios(p_scale=lin8(0.9, 1.1), q_scale=lin8(0.9, 1.1),
                        injection_scale=lin8(0.7, 1.3))
    s27 = S(25, coupled=True).with_(solver="arrow")
    rc27 = ht.hpf_sweep_adaptive(net, dev, s27, sc27)
    rw27 = ht.hpf_sweep_adaptive(net, dev, s27, sc27, warm="linear")
    print(f"[27] exact-linear Norton warm start (one (H-1)n block solve "
          f"per scenario): NR trips mean "
          f"{float(rc27.n_iter.double().mean()):.1f} -> "
          f"{float(rw27.n_iter.double().mean()):.1f} at the same "
          f"fixed points")

    # -- 28. batched background-distortion study --------------------------
    B28, H28 = 8, s27.n_harmonics
    rng28 = np.random.default_rng(5)
    full28 = np.zeros((B28, H28, net.n), complex)
    xsh28 = float(net.bus_Xsh[0])
    full28[:, 2, 0] = (rng28.uniform(0.01, 0.03, B28)
                       * np.exp(1j * rng28.uniform(0, 2 * np.pi, B28))
                       / (1j * xsh28 * 5))
    ibg28 = ht.Cx(T(full28.real), T(full28.imag))
    r28 = ht.background_sweep(net, dev, s27, ibg28)
    thd28 = _np(ht.get_thd(r28.V_m.movedim(0, -1)).THD_F)
    print(f"[28] background study (8 random upstream 5th-harmonic draws, "
          f"full rescue): conv {float(r28.converged.double().mean()):.3f}, "
          f"worst-bus THD spread {thd28.max(axis=0).min():.4f}.."
          f"{thd28.max(axis=0).max():.4f}")

    # -- 29. (outage x scenario) contingency cross ------------------------
    s29 = S(5, coupled=True)
    dev29 = ht.load_device_set(net, s29)   # device tables slice per H
    lin6 = lambda a, b: torch.as_tensor(np.linspace(a, b, 6),
                                        dtype=s29.real_dtype, device=dv)
    r29 = ht.screen_line_outages_sweep(
        net, dev29, s29,
        ht.Scenarios(p_scale=lin6(0.9, 1.1), q_scale=lin6(0.9, 1.1),
                     injection_scale=lin6(0.8, 1.2)))
    k29 = int(r29.ranking[0])
    print(f"[29] N-1 x scenario cross (net2: 4 outages x 6 draws, one "
          f"batch): worst outage line {k29}, p95 dTHD "
          f"{r29.delta_q[k29]:+.4f}, conv {float(r29.conv_frac.min()):.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m hpfx_torch.examples.demo")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, in float32; "
                    "cpu runs in float64)")
    main(ap.parse_args().device)
