"""Reading the card's work from ``torch.profiler`` traces.

Two traced segments follow a traced run's window, each over whole sweep
calls:

- the device segment, traced on the device only (CUPTI's kernel, copy
  and fill records, no host events, so the host runs as in the window):
  the device's busy time, the union of those records, against the
  segment's wall time on the host clock; device time by kernel; and the
  program's launches by (kernel, shape) over the same calls;
- the span segment, traced on the host and the device, with a
  ``record_function`` span around each function that a per-layer metric
  names in its ``SPANS``: the device time of the records launched inside
  any span of each name (a launch belongs to a span when its runtime call
  on the host lies inside it, which also covers the program's ctypes
  launches, which no operator encloses), and the device's idle gaps,
  each named after the innermost host operator running at its middle.
  The host events lengthen this segment, so its idle share is not the
  window's and is not reported.

The traces are written as Chrome JSON under the temporary directory,
read and deleted.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def busy_us(intervals, lo=None, hi=None) -> float:
    """Length of the union of ``intervals`` (start, end), clipped to
    [lo, hi] where given."""
    total, end = 0.0, -float("inf") if lo is None else lo
    for s, e in sorted(intervals):
        s = max(s, end)
        e = e if hi is None else min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


def device_records(events):
    """(name, start, end) of every kernel, copy and fill (us)."""
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def by_name(records) -> dict:
    """Device us summed by record name."""
    acc = collections.Counter()
    for name, s, e in records:
        acc[name] += e - s
    return dict(acc)


def kernel_us(by_kernel: dict, kernel: str) -> float:
    """The device us of one of the program's kernels: its demangled
    template names, ``<kernel><...>(...)``."""
    return sum(us for name, us in by_kernel.items() if f"{kernel}<" in name)


def under_spans(events, names) -> dict:
    """{span name: device us of the records launched inside a span of that
    name}, and under "*" those inside any of them (each record once)."""
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in names:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "args" in e
              and "correlation" in e["args"]}
    recs = [(launch.get(e.get("args", {}).get("correlation")), e["dur"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out = {}
    inside_any = [False] * len(recs)
    for name in names:
        ivs = sorted(spans.get(name, ()))
        starts = [s for s, _ in ivs]
        total = 0.0
        for i, (t, dur) in enumerate(recs):
            if t is None or not ivs:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= ivs[j][1]:
                total += dur
                inside_any[i] = True
        out[name] = total
    out["*"] = sum(d for (_, d), hit in zip(recs, inside_any) if hit)
    return out


def label_gaps(events, gap_list, tid, outer=None) -> collections.Counter:
    """Gap us summed by the innermost host event of thread ``tid`` running
    at each gap's middle ("host code" where none is but ``outer``)."""
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                   and e.get("tid") == tid and e["name"] != outer),
                  key=lambda x: (x[0], -x[1]))
    out = collections.Counter()
    stack, i = [], 0
    for s, e in sorted(gap_list, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "host code"] += e - s
    return out


def _export(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def warm_profiler(device) -> None:
    """Start the profiler's device tracing once on a trivial operation, so
    that its own start-up falls outside the segments."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(16, device=device).sum().item()


def device_segment(run_calls, sync) -> dict:
    """Trace ``run_calls()`` on the device only: busy and wall us, device
    us by record name."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_calls()
        sync()
        wall = time.perf_counter() - t0
    recs = device_records(_export(prof))
    return {"busy_us": busy_us([(s, e) for _, s, e in recs]),
            "wall_us": wall * 1e6, "by_name": by_name(recs),
            "records": len(recs)}


@contextlib.contextmanager
def spanned(targets):
    """Wrap each ``"module:function"`` of ``targets`` in a
    ``record_function`` span named after the function, for the
    duration."""
    from torch.profiler import record_function
    saved = []
    for t in targets:
        mod_name, fn_name = t.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def wrapped(*a, __fn=fn, __name=fn_name, **k):
            with record_function(__name):
                return __fn(*a, **k)

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for mod, fn_name, fn in reversed(saved):
            setattr(mod, fn_name, fn)


def span_segment(run_calls, sync, targets) -> dict:
    """Trace ``run_calls()`` on the host and the device with spans around
    ``targets``: busy us, device us under each span name, and idle us by
    what the host was doing."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with spanned(targets):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench_calls"):
                run_calls()
                sync()
    events = _export(prof)
    top = next(e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "portbench_calls")
    lo, hi = top["ts"], top["ts"] + top["dur"]
    recs = [(s, e) for _, s, e in device_records(events)]
    names = sorted({t.split(":")[1] for t in targets})
    return {"busy_us": busy_us(recs, lo, hi), "wall_us": hi - lo,
            "under": under_spans(events, names),
            "idle_by_host": dict(label_gaps(events, gaps(recs, lo, hi),
                                            top.get("tid"), top["name"]))}
