"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives hpfx_torch's main path — the net2 H<=25 B=16384 float32 adaptive
sweep with the exact-linear seed — on the card, through the hand-written
CUDA kernels, and checks it:

  0. versions, card name and power limit; fails without CUDA;
  1. builds the kernels from the sources in this checkout;
  2. holds each kernel against its plain PyTorch version at the main
     path's shapes (max |x_kernel - x_plain| <= 1e-4 * max |x_plain|) and
     times both with CUDA events;
  3. runs the main path (one warm-up, three timed reps with distinct
     scenario sets, one logged rep for the per-phase breakdown) and
     requires conv >= 0.999, finite converged voltages and launches of
     both kernels;
  4. re-solves a 64-scenario sub-batch in float64 on the card and
     requires max |dV_m| <= 5e-5 pu and max phasor |dV| <= 1e-4 pu.

Every failure raises (nonzero exit, no result line).  The line before the
last is a JSON object per kernel; the last line is
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
H_MAX = 25
PHASE_ITERS = 24
KERNEL_TOL = 1e-4
KERNELS = {
    "gj_kernel": ("hpfx/ops/batched_solve.py:63", [(26, 1, B), (26, 1, 1024)]),
    "gj_kernel_carried": ("hpfx/ops/batched_solve.py:139", [(96, 1, B)]),
}


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


def phase0():
    check("jax" not in sys.modules, "jax was imported")
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


def phase2():
    gen = torch.Generator(device=DEV).manual_seed(1234)
    rows = {}
    for name, (replaces, shapes) in KERNELS.items():
        errs, first = [], None
        for (n, R, Bt) in shapes:
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
                           3 if n > 64 else 10)
            # the layout alternative: transpose to batch-major first
            A_bm = A.permute(2, 0, 1).contiguous()
            x_bm = torch.empty_like(x)

            def batch_major():
                A_bm.copy_(A.permute(2, 0, 1))
                bs._launch(A_bm.permute(1, 2, 0), b, x_bm)
            t_ms = time_ms(batch_major, 20)
            check((x_bm - x).abs().max().item() <= KERNEL_TOL * scale,
                  f"{name}: batch-major operands disagree")
            log(f"[2] {name} n={n} R={R} B={Bt}: max|dx| {err:.3e} "
                f"(scale {scale:.3e}; pivot system {pv:.3e}) kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, kernel on a "
                f"batch-major copy incl. transpose {t_ms:.4f} ms")
            errs.append(err)
            if first is None:
                first = dict(ms=k_ms, plain_ms=p_ms)
        rows[name] = dict(name=name, route="cuda",
                          source="hpfx_torch/ops/csrc/gj_solve.cu",
                          replaces=replaces, max_abs_err=max(errs), **first)
    return rows


def headline():
    s = ht.settings_for_hmax(H_MAX, coupled=True).with_(
        solver="arrow", stable_mismatch=True, big_solve="panel")
    net = ht.load_network(os.path.join(DATA, "net2_buses.csv"),
                          os.path.join(DATA, "net2_lines.csv"), s,
                          device=DEV)
    return s, net, ht.load_device_set(net, s)


def scen(k):
    """bench.py's scenario spread; rep k shifts p_scale by 1e-4·k."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)
    return ht.Scenarios(p_scale=f(np.linspace(0.8, 1.2, B) + 1e-4 * k),
                        q_scale=f(np.linspace(0.8, 1.2, B)),
                        injection_scale=f(np.linspace(0.6, 1.4, B)))


def phase3(s, net, dev):
    run = lambda sc, lg=None: ht.hpf_sweep_device(
        net, dev, s, sc, phase_iters=PHASE_ITERS, warm="linear", log=lg)
    for k in ht.LAUNCHES:
        ht.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run(scen(-1))
    torch.cuda.synchronize()
    launches = dict(ht.LAUNCHES)
    log(f"[3] warm-up sweep {time.perf_counter() - t0:.3f} s, launches "
        f"{launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k in ht.LAUNCHES:
        check(launches[k] > 0, f"the main path never launched {k}")

    reps = []
    for k in range(3):
        sc = scen(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(sc)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        conv = res.converged.float().mean().item()
        it = res.n_iter.float()
        reps.append(dt)
        log(f"[3] rep {k}: {dt:.4f} s, {conv * B / dt:.1f} converged "
            f"solves/s, conv {conv:.6f}, n_iter mean {it.mean().item():.3f} "
            f"max {int(it.max().item())}")
        check(conv >= 0.999, f"rep {k}: conv {conv} < 0.999")
        ok = res.converged
        check(bool(torch.isfinite(res.V_m[ok]).all())
              and bool(torch.isfinite(res.V_a[ok]).all()),
              f"rep {k}: non-finite converged voltages")
        check(tuple(res.V_m.shape) == (B, s.n_harmonics, net.n),
              f"rep {k}: result shape {tuple(res.V_m.shape)}")
        if k == 0:
            rep0 = res

    lg = ht.PhaseLog()
    t0 = time.perf_counter()
    run(scen(3), lg)
    log(f"[3] logged rep {time.perf_counter() - t0:.4f} s:")
    for name in ("setup", "seed", "phase1", "rescue_phase2", "cold_restart",
                 "host_rescue"):
        log(f"    {name:14s} {lg.seconds.get(name, 0.0) * 1e3:10.3f} ms "
            f"{lg.trips.get(name, 0):4d} trips")
    log(f"[3] median {np.median(reps):.4f} s -> "
        f"{B / np.median(reps):.1f} solves/s")
    return rep0, launches


def phase4(s, net, dev, rep0):
    idx = torch.arange(0, B, B // 64, device=DEV)
    sub = ht.Scenarios(*(x[idx].double() for x in scen(0)))
    f64 = torch.float64
    t0 = time.perf_counter()
    r64 = ht.hpf_sweep_device(net.to(dtype=f64), dev.to(dtype=f64),
                              s.with_(dtype="float64"), sub,
                              phase_iters=PHASE_ITERS, warm="linear")
    torch.cuda.synchronize()
    check(bool(r64.converged.all()), "float64 reference did not converge")
    Vm32, Va32 = rep0.V_m[idx].double(), rep0.V_a[idx].double()
    dVm = (Vm32 - r64.V_m).abs().max().item()
    dV = torch.hypot(Vm32 * torch.cos(Va32) - r64.V_m * torch.cos(r64.V_a),
                     Vm32 * torch.sin(Va32) - r64.V_m * torch.sin(r64.V_a)
                     ).max().item()
    log(f"[4] f32 vs f64 on the card, 64 scenarios ({time.perf_counter() - t0:.3f}"
        f" s): max|dV_m| {dVm:.3e} pu, max phasor |dV| {dV:.3e} pu")
    check(dVm <= 5e-5, f"max |dV_m| {dVm} > 5e-5")
    check(dV <= 1e-4, f"max phasor |dV| {dV} > 1e-4")


def main():
    smi = phase0()
    phase1()
    rows = phase2()
    s, net, dev = headline()
    rep0, launches = phase3(s, net, dev)
    phase4(s, net, dev, rep0)
    for name, row in rows.items():
        row["launches"] = launches[name]
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
