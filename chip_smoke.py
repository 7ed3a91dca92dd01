"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives hpfx_torch's paths on the card, through the hand-written CUDA
kernels, and checks them:

  0. versions, card name and power limit; fails without CUDA, and if
     anything of JAX or of the JAX package was imported;
  1. builds the kernels from the sources in this checkout;
  2. holds each kernel against its plain PyTorch version at its paths'
     shapes (max |x_kernel - x_plain| <= 1e-4 * max |x_plain|; the panel
     kernel's pivots exactly and its Ap, TE to 1e-4 of each system's
     scale) and times both with CUDA events; the blocked panel solve is
     held against itself with the plain panel twin, and against float64
     LU, to 1e-4 of the solution's scale;
  3. the net2 main path: the H<=25 B=16384 float32 device-side sweep
     with the exact-linear seed (one warm-up, three timed reps with
     distinct scenario sets, one logged rep for the per-phase breakdown);
     requires conv >= 0.999, finite converged voltages and launches of
     gj_kernel and gj_kernel_carried;
  4. re-solves a 64-scenario sub-batch of it in float64 on the card and
     requires max |dV_m| <= 5e-5 pu and max phasor |dV| <= 1e-4 pu;
  5. the net1 path: bench.py's net1 stage, H<=25 B=2048 float32 on the
     host-driven adaptive schedule from the cold start (warm-up, three
     timed reps, one logged rep); requires conv >= 0.999, finite
     converged voltages and launches of gj_kernel and gj_panel_kernel;
  6. re-solves a 64-scenario sub-batch of it in float64 on the card and
     requires max |dV_m| <= 3e-4 pu and max phasor |dV| <= 5e-4 pu;
  7. the deeper net1-class stages of bench.py at its settings and
     batches (net1 H<=51 B=256, net1 H<=99 B=64, synthetic 64-bus B=256,
     synthetic 128-bus B=128; phase_iters=30): one warm-up and one timed
     rep each, conv >= 0.999 and launches of each stage's kernels.

Every path resets the launch counts just before its warm-up run and reads
them just after it.  Every failure raises (nonzero exit, no result line).
The line before the last is a JSON object per kernel; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false — no result")

import hpfx_torch as ht  # noqa: E402
from hpfx_torch.ops import _build, batched_solve as bs  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "hpfx", "data")
DEV = torch.device("cuda:0")
B = 16384
B_NET1 = 2048
H_MAX = 25
PHASE_ITERS = 24
KERNEL_TOL = 1e-4
#: kernel -> (TPU kernel it replaces, source, solve shapes (n, R, B)); the
#: panel kernel's shapes are panels (N, Pw, B), see PANEL_SOLVES
KERNELS = {
    "gj_kernel": ("hpfx/ops/batched_solve.py:63",
                  "hpfx_torch/ops/csrc/gj_solve.cu",
                  [(26, 1, B), (26, 1, 1024), (40, 15, 13 * B_NET1)]),
    "gj_kernel_carried": ("hpfx/ops/batched_solve.py:139",
                          "hpfx_torch/ops/csrc/gj_solve.cu",
                          [(96, 1, B)]),
    "gj_panel_kernel": ("hpfx/ops/batched_solve.py:452",
                        "hpfx_torch/ops/csrc/gj_panel.cu",
                        [(192, 32, 2048), (384, 32, 256), (704, 32, 64),
                         (800, 32, 128)]),
}
#: the blocked solves the net1-class paths make (dim, B): the capacitance
#: systems of net1 at H<=25/51/99 and of the 128-bus feeder
PANEL_SOLVES = [(182, 2048), (364, 256), (700, 64), (780, 128)]
#: bench.py's deeper net1-class stages: (name, network, H max, B,
#: scenario spread (p_lo, p_hi, inj_lo, inj_hi), kernels the path runs)
DEEP_STAGES = [
    ("net1_h51", "net1", 51, 256, (0.8, 1.2, 0.6, 1.4),
     ("gj_kernel", "gj_panel_kernel")),
    ("net1_h99", "net1", 99, 64, (0.8, 1.2, 0.6, 1.4),
     ("gj_kernel", "gj_panel_kernel")),
    ("synthetic_n64", (64, 7), 25, 256, (0.9, 1.1, 0.7, 1.2),
     ("gj_kernel_carried", "gj_panel_kernel")),
    ("synthetic_n128", (128, 30), 25, 128, (0.95, 1.05, 0.8, 1.1),
     ("gj_panel_kernel",)),
]


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def reset_launches():
    for k in ht.LAUNCHES:
        ht.LAUNCHES[k] = 0


def phase0():
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "hpfx"))
    check(not bad, f"JAX or the JAX package was imported: {bad}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    return smi


def phase1():
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"    ptxas: {line.strip()}")


def systems(n, R, Bt, gen, pivot_case):
    """Diagonally boosted random systems (tests/test_ops.py:14-19); with
    ``pivot_case`` system 0 has a zero diagonal and needs pivoting."""
    A = torch.randn((n, n, Bt), generator=gen, device=DEV)
    A += 3.0 * n ** 0.5 * torch.eye(n, device=DEV)[:, :, None]
    if pivot_case:
        shift = torch.roll(torch.eye(n, device=DEV), 1, dims=1)
        A0 = 0.1 * torch.randn((n, n), generator=gen, device=DEV)
        A0 += 3.0 * n ** 0.5 * shift
        A0.fill_diagonal_(0.0)
        A[:, :, 0] = A0
    b = torch.randn((n, R, Bt), generator=gen, device=DEV)
    return A.contiguous(), b.contiguous()


def check_solve_kernel(name, gen):
    """gj_kernel / gj_kernel_carried against the plain twin."""
    errs, first = [], None
    for (n, R, Bt) in KERNELS[name][2]:
        A, b = systems(n, R, Bt, gen, pivot_case=True)
        before = ht.LAUNCHES[name]
        x = ht.gauss_solve_lanes(A, b)
        torch.cuda.synchronize()
        check(ht.LAUNCHES[name] > before, f"{name} was not launched")
        x_ref = ht.gj_solve_lanes_ref(A, b)
        scale = x_ref.abs().max().item()
        err = (x - x_ref).abs().max().item()
        pv = (x[:, :, 0] - x_ref[:, :, 0]).abs().max().item()
        check(np.isfinite(err) and err <= KERNEL_TOL * scale,
              f"{name} at {(n, R, Bt)}: max err {err} > "
              f"{KERNEL_TOL} * {scale}")
        k_ms = time_ms(lambda: ht.gauss_solve_lanes(A, b), 20)
        p_ms = time_ms(lambda: ht.gj_solve_lanes_ref(A, b),
                       3 if n > 32 else 10)
        msg = (f"[2] {name} n={n} R={R} B={Bt}: max|dx| {err:.3e} (scale "
               f"{scale:.3e}; pivot system {pv:.3e}) kernel {k_ms:.4f} ms, "
               f"plain {p_ms:.4f} ms")
        if (n, R, Bt) == (26, 1, B) or (n, R, Bt) == (96, 1, B):
            # the layout alternative: transpose to batch-major first
            A_bm = A.permute(2, 0, 1).contiguous()
            x_bm = torch.empty_like(x)

            def batch_major():
                A_bm.copy_(A.permute(2, 0, 1))
                bs._launch(A_bm.permute(1, 2, 0), b, x_bm)
            t_ms = time_ms(batch_major, 20)
            check((x_bm - x).abs().max().item() <= KERNEL_TOL * scale,
                  f"{name}: batch-major operands disagree")
            msg += f", kernel on a batch-major copy incl. transpose {t_ms:.4f} ms"
        log(msg)
        errs.append(err)
        if first is None:
            first = dict(ms=k_ms, plain_ms=p_ms)
        del A, b, x, x_ref
    return errs, first


def check_panel_kernel(gen):
    """gj_panel_kernel against gj_panel_ref on one panel per dim, as a
    middle panel sees it (a third of the rows already used), then the
    whole blocked solve with the kernel against the same solve with the
    plain panel twin and against float64 LU."""
    name = "gj_panel_kernel"
    errs, first = [], None
    for (N, Pw, Bt) in KERNELS[name][2]:
        A, _ = systems(N, 1, Bt, gen, pivot_case=True)
        panel = A[:, N // 3:N // 3 + Pw]           # a strided column slice
        used = (torch.rand((N, Bt), generator=gen, device=DEV)
                < 1.0 / 3.0).float()
        before = ht.LAUNCHES[name]
        outs = ht.gj_panel_lanes(panel, used)
        torch.cuda.synchronize()
        check(ht.LAUNCHES[name] > before, f"{name} was not launched")
        refs = ht.gj_panel_ref(panel, used)
        # E and used: the same pivot sequence, exactly.  Ap and TE: per
        # system, against the largest magnitude of its elimination (its
        # |TE|, ~1e2 on the pivot systems): Ap's entries are 0/1 plus the
        # cancellation noise of those intermediates, taken in another
        # rounding order (the kernel fuses multiply-adds)
        check(torch.equal(outs[2], refs[2]) and torch.equal(outs[3], refs[3]),
              f"{name} at {(N, Pw, Bt)}: pivot sequences differ")
        sys_scale = torch.maximum(refs[0].abs().amax(dim=(0, 1)),
                                  refs[1].abs().amax(dim=(0, 1)))
        line = []
        for what, o, r in zip(("Ap", "TE"), outs, refs):
            d = (o - r).abs().amax(dim=(0, 1))
            rel = (d / sys_scale).max().item()
            check(np.isfinite(rel) and rel <= KERNEL_TOL,
                  f"{name} {what} at {(N, Pw, Bt)}: max err / system scale "
                  f"{rel} > {KERNEL_TOL}")
            line.append(f"{what} {d.max().item():.3e} abs, {rel:.3e} of "
                        "system scale")
            errs.append(d.max().item())
        k_ms = time_ms(lambda: ht.gj_panel_lanes(panel, used), 10)
        p_ms = time_ms(lambda: ht.gj_panel_ref(panel, used), 3)
        log(f"[2] {name} N={N} Pw={Pw} B={Bt}: E and used equal; "
            f"{', '.join(line)}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if first is None:
            first = dict(ms=k_ms, plain_ms=p_ms)
        del A, panel, used, outs, refs

    for (n, Bt) in PANEL_SOLVES:
        A, b = systems(n, 1, Bt, gen, pivot_case=True)
        x = ht.panel_gj_solve_lanes(A, b)
        # the same blocked solve with the plain panel twin
        bs.gj_panel_lanes = bs.gj_panel_ref
        try:
            x_ref = ht.panel_gj_solve_lanes(A, b)
            p_ms = time_ms(lambda: ht.panel_gj_solve_lanes(A, b), 2)
        finally:
            bs.gj_panel_lanes = ht.gj_panel_lanes
        k_ms = time_ms(lambda: ht.panel_gj_solve_lanes(A, b), 5)
        x64 = torch.linalg.solve(A.double().permute(2, 0, 1),
                                 b.double().permute(2, 0, 1)).permute(1, 2, 0)
        scale = x_ref.abs().max().item()
        err = (x - x_ref).abs().max().item()
        err64 = (x.double() - x64).abs().max().item()
        pv = (x[:, :, 0] - x_ref[:, :, 0]).abs().max().item()
        check(np.isfinite(err) and err <= KERNEL_TOL * scale,
              f"panel solve at {(n, Bt)}: max err {err} > "
              f"{KERNEL_TOL} * {scale}")
        check(err64 <= KERNEL_TOL * scale,
              f"panel solve at {(n, Bt)}: {err64} from float64 LU")
        log(f"[2] panel_gj_solve_lanes n={n} B={Bt}: max|dx| {err:.3e} "
            f"(scale {scale:.3e}; pivot system {pv:.3e}; vs f64 LU "
            f"{err64:.3e}) with the kernel {k_ms:.4f} ms, with the plain "
            f"twin {p_ms:.4f} ms")
        errs.append(err)
        del A, b, x, x_ref, x64
    torch.cuda.empty_cache()
    return errs, first


def phase2():
    gen = torch.Generator(device=DEV).manual_seed(1234)
    rows = {}
    for name, (replaces, source, _) in KERNELS.items():
        if name == "gj_panel_kernel":
            errs, first = check_panel_kernel(gen)
        else:
            errs, first = check_solve_kernel(name, gen)
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, max_abs_err=max(errs), **first)
    return rows


def settings(h_max):
    return ht.settings_for_hmax(h_max, coupled=True).with_(
        solver="arrow", stable_mismatch=True, big_solve="panel")


def fixture_net(name, h_max):
    s = settings(h_max)
    net = ht.load_network(os.path.join(DATA, f"{name}_buses.csv"),
                          os.path.join(DATA, f"{name}_lines.csv"), s,
                          device=DEV)
    return s, net, ht.load_device_set(net, s)


def scen(k, Bt, spread=None):
    """bench.py's scenario spread (default (0.8, 1.2, 0.6, 1.4)); rep k
    shifts p_scale by 1e-4·k."""
    p_lo, p_hi, i_lo, i_hi = spread or (0.8, 1.2, 0.6, 1.4)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)
    return ht.Scenarios(p_scale=f(np.linspace(p_lo, p_hi, Bt) + 1e-4 * k),
                        q_scale=f(np.linspace(p_lo, p_hi, Bt)),
                        injection_scale=f(np.linspace(i_lo, i_hi, Bt)))


def check_result(res, Bt, s, net, tag):
    conv = res.converged.float().mean().item()
    check(conv >= 0.999, f"{tag}: conv {conv} < 0.999")
    ok = res.converged
    check(bool(torch.isfinite(res.V_m[ok]).all())
          and bool(torch.isfinite(res.V_a[ok]).all()),
          f"{tag}: non-finite converged voltages")
    check(tuple(res.V_m.shape) == (Bt, s.n_harmonics, net.n),
          f"{tag}: result shape {tuple(res.V_m.shape)}")
    return conv


def warm_up(run, Bt, spread, kernels, tag):
    """The path's first run, with the launch counts reset just before it
    and read just after; requires a launch of each of ``kernels``."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(scen(-1, Bt, spread))
    torch.cuda.synchronize()
    launches = dict(ht.LAUNCHES)
    log(f"[{tag}] warm-up sweep {time.perf_counter() - t0:.3f} s, launches "
        f"{launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k in kernels:
        check(launches[k] > 0, f"the {tag} path never launched {k}")
    return launches


def timed_reps(run, Bt, s, net, tag, reps, spread=None):
    times, first = [], None
    for k in range(reps):
        sc = scen(k, Bt, spread)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(sc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        conv = check_result(res, Bt, s, net, f"{tag} rep {k}")
        it = res.n_iter.float()
        times.append(dt)
        log(f"[{tag}] rep {k}: {dt:.4f} s, {conv * Bt / dt:.1f} converged "
            f"solves/s, conv {conv:.6f}, n_iter mean {it.mean().item():.3f} "
            f"max {int(it.max().item())}")
        if first is None:
            first = res
    return times, first


def logged_rep(run, Bt, tag, phases):
    lg = ht.PhaseLog()
    t0 = time.perf_counter()
    run(scen(3, Bt), lg)
    log(f"[{tag}] logged rep {time.perf_counter() - t0:.4f} s:")
    for name in phases:
        log(f"    {name:14s} {lg.seconds.get(name, 0.0) * 1e3:10.3f} ms "
            f"{lg.trips.get(name, 0):4d} trips")


def compare_f64(res32, run64, Bt, vm_tol, phasor_tol, tag):
    """Re-solve 64 scenarios of rep 0 in float64 on the card."""
    idx = torch.arange(0, Bt, Bt // 64, device=DEV)
    sub = ht.Scenarios(*(x[idx].double() for x in scen(0, Bt)))
    t0 = time.perf_counter()
    r64 = run64(sub)
    torch.cuda.synchronize()
    check(bool(r64.converged.all()), f"{tag}: float64 reference did not "
          "converge")
    Vm32, Va32 = res32.V_m[idx].double(), res32.V_a[idx].double()
    dVm = (Vm32 - r64.V_m).abs().max().item()
    dV = torch.hypot(Vm32 * torch.cos(Va32) - r64.V_m * torch.cos(r64.V_a),
                     Vm32 * torch.sin(Va32) - r64.V_m * torch.sin(r64.V_a)
                     ).max().item()
    log(f"[{tag}] f32 vs f64 on the card, 64 scenarios "
        f"({time.perf_counter() - t0:.3f} s): max|dV_m| {dVm:.3e} pu, max "
        f"phasor |dV| {dV:.3e} pu")
    check(dVm <= vm_tol, f"{tag}: max |dV_m| {dVm} > {vm_tol}")
    check(dV <= phasor_tol, f"{tag}: max phasor |dV| {dV} > {phasor_tol}")


def phase3_4():
    """The net2 main path and its float64 check."""
    s, net, dev = fixture_net("net2", H_MAX)
    run = lambda sc, lg=None: ht.hpf_sweep_device(
        net, dev, s, sc, phase_iters=PHASE_ITERS, warm="linear", log=lg)
    launches = warm_up(run, B, None, ("gj_kernel", "gj_kernel_carried"), 3)
    reps, rep0 = timed_reps(run, B, s, net, 3, 3)
    logged_rep(run, B, 3, ("setup", "seed", "phase1", "rescue_phase2",
                           "cold_restart", "host_rescue"))
    log(f"[3] median {np.median(reps):.4f} s -> "
        f"{B / np.median(reps):.1f} solves/s")
    f64 = torch.float64
    compare_f64(rep0, lambda sub: ht.hpf_sweep_device(
        net.to(dtype=f64), dev.to(dtype=f64), s.with_(dtype="float64"), sub,
        phase_iters=PHASE_ITERS, warm="linear"), B, 5e-5, 1e-4, 4)
    return launches


def adaptive(s, net, dev, phase_iters):
    return lambda sc, lg=None: ht.hpf_sweep_adaptive(
        net, dev, s, sc, phase_iters=phase_iters, phase2_settings=s,
        warm="cold", log=lg)


def phase5_6():
    """The net1 H<=25 path and its float64 check."""
    s, net, dev = fixture_net("net1", H_MAX)
    run = adaptive(s, net, dev, PHASE_ITERS)
    launches = warm_up(run, B_NET1, None, ("gj_kernel", "gj_panel_kernel"), 5)
    reps, rep0 = timed_reps(run, B_NET1, s, net, 5, 3)
    logged_rep(run, B_NET1, 5, ("phase1", "phase2", "host_rescue"))
    log(f"[5] median {np.median(reps):.4f} s -> "
        f"{B_NET1 / np.median(reps):.1f} solves/s")
    f64 = torch.float64
    compare_f64(rep0, lambda sub: adaptive(
        s.with_(dtype="float64"), net.to(dtype=f64), dev.to(dtype=f64),
        PHASE_ITERS)(sub), B_NET1, 3e-4, 5e-4, 6)
    return launches


def phase7():
    """bench.py's deeper net1-class stages: one warm-up, one timed rep."""
    total = {k: 0 for k in ht.LAUNCHES}
    for name, net_spec, h_max, Bt, spread, kernels in DEEP_STAGES:
        if isinstance(net_spec, str):
            s, net, dev = fixture_net(net_spec, h_max)
        else:
            s = settings(h_max)
            net = ht.synthetic_feeder(*net_spec, s, components=("SMPS",),
                                      seed=1, device=DEV)
            dev = ht.load_device_set(net, s)
        run = adaptive(s, net, dev, 30)
        tag = f"7 {name}"
        launches = warm_up(run, Bt, spread, kernels, tag)
        timed_reps(run, Bt, s, net, tag, 1, spread)
        for k in total:
            total[k] += launches[k]
        torch.cuda.empty_cache()
    return total


def main():
    t_start = time.perf_counter()
    smi = phase0()
    phase1()
    rows = phase2()
    paths = [phase3_4(), phase5_6(), phase7()]
    for name, row in rows.items():
        row["launches"] = sum(p[name] for p in paths)
    log(f"[8] whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}
        for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
