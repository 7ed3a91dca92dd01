"""Device profile of the port's net1 path on one NVIDIA GPU.

    python3 profile_net1.py

Runs chip_smoke.py's net1 stage (H<=25 B=2048 float32 on the host-driven
adaptive schedule from the cold start): one warm-up sweep and one sweep
without the profiler, then

  - the idle share: one sweep traced on the device only (CUPTI's kernel,
    copy and fill records, no host events), its device busy time (the
    union of those records) against the same sweep's wall time;
  - the shares: one sweep under torch.profiler with host events and spans
    around the arrow step (lanes.arrow_step_lanes), every batched solve
    (lanes.batched_solve_lanes), the blocked panel solve
    (ops.batched_solve.panel_gj_solve_lanes) and the mismatch
    (lanes.mismatch_lanes): each span's device time as a share of busy
    time with the kernels that take most of it, and the kernels that take
    the most device time overall.  The host events lengthen this sweep,
    so its idle share is printed but is not the sweep's.

Prints each sweep's wall time and the card's name and power limit.
Writes the device-only trace to build/net1_device_trace.json.  Fails
without CUDA.
"""
import collections
import functools
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs  # exits without CUDA
from hpfx_torch import lanes
from hpfx_torch.ops import _build, batched_solve as bs

SPANS = ((lanes, "arrow_step_lanes"), (lanes, "batched_solve_lanes"),
         (bs, "panel_gj_solve_lanes"), (lanes, "mismatch_lanes"))


def spanned(fn, name):
    @functools.wraps(fn)
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def kernels_under(evt, acc, own):
    """Add the device time of every kernel launched under ``evt`` (a host
    event) to ``acc`` by kernel name (us): those the profiler attached to
    host events, and the port's own kernels by ``own`` (id() of the host
    launch event -> (name, us))."""
    for k in evt.kernels:
        acc[k.name] += k.duration
    if id(evt) in own:
        name, us = own[id(evt)]
        acc[name] += us
    for ch in evt.cpu_children:
        kernels_under(ch, acc, own)


def own_launches(events, dev_ev):
    """The port's kernels, launched through ctypes, to which the profiler
    attaches no host event: pair their launches (cudaLaunchKernel outside
    any aten:: op) with their device events (named after a kernel of
    ops.batched_solve.LAUNCHES), both in time order on the one stream.
    Returns {id() of the launch event: (kernel name, device us)}."""
    launches = sorted((e for e in events
                       if e.device_type == DeviceType.CPU
                       and e.name == "cudaLaunchKernel"
                       and not (e.cpu_parent and
                                e.cpu_parent.name.startswith("aten::"))),
                      key=lambda e: e.time_range.start)
    kernels = sorted((e for e in dev_ev
                      if any(k in e.name for k in bs.LAUNCHES)),
                     key=lambda e: e.time_range.start)
    cs.check(len(launches) == len(kernels),
             f"{len(launches)} launches outside aten ops, {len(kernels)} "
             "kernels of the port")
    return {id(h): (k.name, k.time_range.end - k.time_range.start)
            for h, k in zip(launches, kernels)}


def busy_us(intervals, lo, hi):
    """Length of the union of ``intervals`` clipped to [lo, hi] (us)."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def timed_sweep(run, seed):
    """One net1 sweep from scenario set ``seed``: (result, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(cs.scen(seed, cs.B_NET1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    conv = res.converged.float().mean().item()
    cs.check(conv >= 0.999, f"net1 sweep {seed}: conv {conv}")
    return res, wall


def device_idle(run):
    """Idle share of one sweep traced on the device only: 1 - (union of
    its kernels, copies and fills) / (its wall time)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed_sweep(run, 1)
    path = os.path.join(cs.REPO, "build", "net1_device_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    recs = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    cs.check(recs, "the device-only trace holds no kernel")
    busy = busy_us(recs, min(r[0] for r in recs), max(r[1] for r in recs))
    cs.log(f"[p] device-only trace: sweep {wall:.4f} s (host clock), "
           f"{len(recs)} device records, busy {busy / 1e3:.3f} ms, idle "
           f"share {1.0 - busy / (wall * 1e6):.4f}")


def main():
    smi = cs.phase0()
    _build.load_library()
    s, net, dev = cs.fixture_net("net1", cs.H_MAX)
    run = cs.adaptive(s, net, dev, cs.PHASE_ITERS)
    run(cs.scen(-1, cs.B_NET1))
    _, wall = timed_sweep(run, 2)
    cs.log(f"[p] net1 H<={cs.H_MAX} B={cs.B_NET1}: sweep without the "
           f"profiler {wall:.4f} s (host clock)")
    device_idle(run)
    for mod, name in SPANS:
        setattr(mod, name, spanned(getattr(mod, name), name))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("sweep"):
            t0 = time.perf_counter()
            res = run(cs.scen(0, cs.B_NET1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    conv = res.converged.float().mean().item()
    cs.check(conv >= 0.999, f"profiled net1 sweep: conv {conv}")
    events = prof.events()
    sweep = next(e for e in events
                 if e.name == "sweep" and e.device_type == DeviceType.CPU)
    lo, hi = sweep.time_range.start, sweep.time_range.end
    # kernels, copies and fills; not the spans' images on the device
    spans = {"sweep", *(name for _, name in SPANS)}
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in spans
              and not getattr(e, "is_user_annotation", False)]
    cs.check(dev_ev, "the profiler saw no device activity")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in dev_ev],
                   lo, hi)
    window = hi - lo
    cs.log(f"[p] net1 H<={cs.H_MAX} B={cs.B_NET1}: sweep with host events "
           f"{wall:.4f} s (host clock), conv {conv:.6f}; window "
           f"{window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle "
           f"share under host tracing {1.0 - busy / window:.4f}")
    own = own_launches(events, dev_ev)
    for _, name in SPANS:
        host = [e for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        inner = collections.Counter()
        for e in host:
            kernels_under(e, inner, own)
        t, n = sum(inner.values()), len(host)
        cs.log(f"[p] span {name}: {n} calls, device {t / 1e3:.3f} ms, "
               f"{t / busy:.4f} of busy")
        for k, tk in inner.most_common(5):
            share = tk / max(t, 1e-9)
            cs.log(f"[p]     {tk / 1e3:9.3f} ms {share:.4f} of the span  "
                   f"{k[:90]}")
    by_kernel = collections.Counter()
    for e in dev_ev:
        by_kernel[e.name] += e.time_range.end - e.time_range.start
    for k, t in by_kernel.most_common(12):
        cs.log(f"[p] {t / 1e3:9.3f} ms {t / busy:.4f} of busy  {k[:100]}")
    for name in ("gj_kernel", "gj_kernel_carried", "gj_panel_kernel"):
        # the demangled template name, e.g. "...::gj_kernel<2, 56, false>(..."
        t = sum(tk for k, tk in by_kernel.items() if f"{name}<" in k)
        cs.log(f"[p] {name} {t / 1e3:.3f} ms, {t / busy:.4f} of busy")
    print(smi)


if __name__ == "__main__":
    main()
