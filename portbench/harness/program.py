"""The program's own spans in a trace of the span segment.

The port opens ``record_function`` spans named ``hpfx.*`` on its sweep
path (``hpfx_torch/utils/profiling.py``: the entry call, its phases, each
Newton trip and its stages, each batched solve, each collective).  They
are ``user_annotation`` events on the host clock, which is the clock of
the device records.  For each span name, :func:`program` gives

- ``n``, the spans of that name, and ``wall_us``, their summed length;
- ``device_us`` and ``records``: the device records (kernels, copies,
  fills) launched inside a span of that name, at any depth below it.  A
  record is launched where the runtime call with its correlation id runs,
  as ``trace.under_spans`` pairs them, which covers the program's ctypes
  launches too;
- ``idle_us``: the device's idle gaps over [lo, hi] whose middle lies
  inside a span of that name.

Spans of one name that nest count a record or a gap once.
"""
from __future__ import annotations

import bisect
import collections

from .trace import DEVICE_CATS, gaps

PREFIX = "hpfx."


def _union(intervals):
    """The disjoint (start, end) stretches that ``intervals`` cover."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(union, starts, t) -> bool:
    if t is None:
        return False
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and t <= union[j][1]


def program(events, lo: float, hi: float) -> dict:
    """{span name: {"n", "wall_us", "device_us", "records", "idle_us"}}
    for every ``hpfx.*`` span of the Chrome trace ``events``; the idle
    gaps are taken over [lo, hi] (us)."""
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" \
                and e.get("name", "").startswith(PREFIX):
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "args" in e
              and "correlation" in e["args"]}
    recs = [(launch.get(e.get("args", {}).get("correlation")), e["ts"],
             e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    idle = gaps([(s, e) for _, s, e in recs], lo, hi)
    out = {}
    for name, ivs in sorted(spans.items()):
        union = _union(ivs)
        starts = [s for s, _ in union]
        hit = [(s, e) for t, s, e in recs if _inside(union, starts, t)]
        out[name] = {
            "n": len(ivs), "wall_us": sum(e - s for s, e in ivs),
            "device_us": sum(e - s for s, e in hit), "records": len(hit),
            "idle_us": sum(e - s for s, e in idle
                           if _inside(union, starts, (s + e) / 2))}
    return out
