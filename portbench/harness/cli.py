"""One run of one cell: set-up, the timed window, the traced segments, the
check, the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up loads (on a cell's first run in a checkout: builds) the port's
kernel library in its fixed directory inside the checkout
(``build/hpfx_torch_kernels``), loads the configuration's network and
devices onto the card, and runs one warm-up call on scenarios that are
not timed.  The window is a closed loop with one caller: sweep
calls back to back, each on a fresh batch drawn from the seed, each
timed on the host clock from before the call to after
``torch.cuda.synchronize()``, until ``--seconds`` have passed.  A traced
run (``--trace 1``) keeps a ``PhaseLog`` over the window's calls where
the entry takes one, then traces a few more calls (``trace.py``) and
reports the per-layer metrics; an untraced run reports the end-to-end
ones.  Every run then checks the window's sampled answers against the
float64 reference (``check.py``).

A cell on several cards starts one process per card, joined by NCCL
through a file store under the temporary directory; rank 0 prints the
result.  The last line on standard output is the result's JSON object;
the last lines on standard error are the numbers checked, each beside
its limit.  Per-call times go to ``portbench_out/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from . import cards, check, guard, spec, traffic

RUN = os.path.join(spec.BENCH_DIR, "run.py")
OUT_DIR = os.path.join(spec.ROOT, "portbench_out")
#: the stream of the traced segments' calls
TRACE_STREAM = 2
#: calls in each traced segment
TRACE_CALLS = 2
#: the window's slowest calls, whose every lane the check compares
SLOWEST_CALLS = 2
#: seconds a rank may take past the parent's own limit before it is ended
RANK_GRACE_S = 330


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards, started by the run's first process
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    if cell.chips > 1 and args.rank is None:
        return launch(cell, argv, t_start)
    cards.require(cell.chips)
    t0 = t_start if args.t0 is None else args.t0
    return Run(cell, args, args.rank or 0, args.world, t0).go()


# ---------------------------------------------------------------------------
# several cards: one process a card
# ---------------------------------------------------------------------------

def child_command(argv, rank: int, world: int, t0: float, store: str):
    """The command of rank ``rank``."""
    return [sys.executable, RUN, *argv, "--rank", str(rank), "--world",
            str(world), "--t0", repr(t0), "--store", store]


def launch(cell: spec.Cell, argv, t_start: float) -> int:
    """Start a process for each of the cell's cards, wait for all, and
    fail if any fails.  Rank 0 writes the result."""
    cards.require(cell.chips)
    build_kernels()
    world = cell.chips
    tmp = tempfile.mkdtemp(prefix="portbench_ranks_")
    store = os.path.join(tmp, "store")
    procs, logs = [], []
    try:
        for r in range(world):
            err = None
            if r:
                err = open(os.path.join(tmp, f"rank{r}.log"), "w")
                logs.append(err)
            procs.append(subprocess.Popen(
                child_command(argv, r, world, t_start, store),
                stdout=None if r == 0 else subprocess.DEVNULL,
                stderr=err))
        deadline = time.time() + RANK_GRACE_S
        rcs = [None] * world
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
                    if rcs[i] not in (None, 0):
                        deadline = min(deadline, time.time() + 20)
            if time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for fh in logs:
            fh.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r in range(1, world):
            if rcs[r]:
                with open(os.path.join(tmp, f"rank{r}.log")) as fh:
                    log(f"portbench: rank {r} exited {rcs[r]}:\n"
                        + fh.read()[-4000:])
        log(f"portbench: ranks exited {rcs}")
        return 1
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    os.rmdir(tmp)
    return 0


def build_kernels() -> None:
    """Build the port's kernel library (a no-op once it is there)."""
    from hpfx_torch.ops import _build
    _build.load_library()


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

class Run:
    def __init__(self, cell: spec.Cell, args, rank: int, world: int,
                 t0: float):
        self.cell, self.args = cell, args
        self.rank, self.world, self.t0 = rank, world, t0
        self.mix, self.wl = cell.traffic, cell.workload

    # -- plumbing -----------------------------------------------------------
    def sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def all_ranks(self, obj):
        """``obj`` of every rank, in rank order."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], device=self.dev)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def scenarios(self, batch, n=None):
        """The batch's first ``n`` (default: all) scenarios on the card."""
        import hpfx_torch as ht
        sc = batch.scales
        put = lambda x: x[:n].to(self.dev)
        return ht.Scenarios(put(sc["p_scale"]), put(sc["q_scale"]),
                            put(sc["injection_scale"]))

    # -- the run ------------------------------------------------------------
    def setup(self):
        import torch
        self.dev = cards.device(self.rank)
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        if self.world > 1:
            import torch.distributed as dist
            backend = "nccl" if self.dev.type == "cuda" else "gloo"
            dist.init_process_group(
                backend, store=dist.FileStore(self.args.store, self.world),
                rank=self.rank, world_size=self.world,
                **({"device_id": self.dev} if backend == "nccl" else {}))
        import hpfx_torch as ht
        if self.dev.type == "cuda":
            build_kernels()
        cfg = self.cell.config
        self.settings = ht.settings_for_hmax(int(self.mix["h_max"]),
                                             **cfg["settings"])
        path = lambda p: os.path.join(spec.ROOT, p)
        self.net = ht.load_network(path(cfg["buses"]), path(cfg["lines"]),
                                   self.settings, device=self.dev)
        self.devices = ht.load_device_set(
            self.net, self.settings, search_dirs=(path(cfg["device_tables"]),))
        self.entry = spec.entry(self.cell.entry)
        self.call = self.entry.make(self.net, self.devices, self.settings,
                                    self.wl["args"], self.world)
        b = traffic.draw(self.mix, self.args.seed, 0, stream=traffic.WARMUP)
        self.call(self.scenarios(b))
        self.sync()
        if self.entry.FLOAT64_RESCUE:
            # the rescue's float64 solves, so that their first use in the
            # window finds them set up
            b = traffic.draw(self.mix, self.args.seed, 0,
                             stream=traffic.WARMUP)
            f64 = torch.float64
            ht.hpf_sweep(self.net.to(dtype=f64), self.devices.to(dtype=f64),
                         self.settings.with_(dtype="float64"),
                         self.scenarios(b, 4).to(f64))
            self.sync()

    def window(self):
        """The timed closed loop: (call seconds, converged counts, sampled
        answers, window seconds, set-up seconds).  Each call gives up its
        sampled lanes (``check.lanes``); the ``SLOWEST_CALLS`` slowest
        calls are kept on the card and give up every lane once the window
        has closed."""
        import torch

        import hpfx_torch as ht
        self.phases = None
        if self.args.trace and self.entry.SUPPORTS_LOG:
            self.phases = ht.PhaseLog()
        sample = int(self.wl["sample_per_call"]) if self.rank == 0 else 0
        times, conv, samples, slow = [], [], [], []
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()
        self.sync()
        t_first = None
        deadline = time.perf_counter() + self.args.seconds
        k = 0
        while True:
            b = traffic.draw(self.mix, self.args.seed, k, sample)
            sc = self.scenarios(b)
            self.sync()
            if t_first is None:
                setup_s = time.time() - self.t0
                t_first = time.perf_counter()
            c0 = time.perf_counter()
            res = self.call(sc, self.phases)
            self.sync()
            c1 = time.perf_counter()
            times.append(c1 - c0)
            conv.append(int(res.converged.sum()))
            if sample:
                samples.append(check.take(
                    res, check.lanes(res, b.sample, sample), b.scales))
                if len(slow) < SLOWEST_CALLS or times[-1] > slow[0][0]:
                    slow = sorted([*slow, (times[-1], k, res, b.scales)],
                                  key=lambda x: x[0])[-SLOWEST_CALLS:]
            del res
            k += 1
            if self.agree(c1 >= deadline):
                break
        window_s = c1 - t_first
        for _, _, res, scales in slow:
            samples.append(check.take(res, torch.arange(res.V_m.shape[0]),
                                      scales))
        return times, conv, samples, window_s, setup_s

    def traced(self):
        """The device segment and the span segment (``trace.py``) over
        ``TRACE_CALLS`` calls each, and the program's launches by shape
        over the device segment's calls."""
        from hpfx_torch.ops import batched_solve as bs
        from . import trace
        k = [0]

        def run_calls():
            for _ in range(TRACE_CALLS):
                b = traffic.draw(self.mix, self.args.seed, k[0],
                                 stream=TRACE_STREAM)
                self.call(self.scenarios(b))
                k[0] += 1

        trace.warm_profiler(self.dev)
        bs.LAUNCHES_BY_SHAPE.clear()
        seg = trace.device_segment(run_calls, self.sync)
        seg["launches"] = {k_: c for k_, c in bs.LAUNCHES_BY_SHAPE.items()}
        targets = sorted({t for m in self.cell.per_layer
                          for t in getattr(spec.metric_module(m["name"]),
                                           "SPANS", ())})
        spans = None
        if self.rank == 0:
            spans = trace.span_segment(run_calls, self.sync, targets)
        else:
            run_calls()
            self.sync()
        return seg, spans

    def go(self) -> int:
        import torch
        self.setup()
        guard.check("after set-up")
        times, conv, samples, window_s, setup_s = self.window()
        peak = 0
        if self.dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.dev)
        peaks = self.all_ranks(peak)
        guard.check("after the window")
        B = int(self.mix["batch"])
        record = {"cell": self.cell.name, "batch": B, "calls": times,
                  "converged": conv, "window_s": window_s,
                  "setup_s": setup_s, "phases": None, "device": None,
                  "spans": None}
        if self.phases is not None:
            record["phases"] = {"seconds": dict(self.phases.seconds),
                                "trips": dict(self.phases.trips)}
        device = {"platform": "gpu" if self.dev.type == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(self.dev)
                           if self.dev.type == "cuda" else "cpu"),
                  "count": self.world, "memory_peak_bytes": max(peaks)}
        if self.args.trace:
            seg, spans = self.traced()
            busy = self.all_ranks(seg["busy_us"] / 1e6)
            device["busy_s"] = sum(busy) / len(busy)
            device["window_s"] = seg["wall_us"] / 1e6
            record["device"], record["spans"] = seg, spans
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        result = None
        if self.rank == 0:
            ok, numbers, notes = check.judge(
                samples, check.problem(self.cell.config, int(self.mix["h_max"])),
                self.wl["limits"], self.dev, self.settings.max_iter_h)
            result = self.result(record, device, ok, numbers, sum(conv),
                                 len(times) * B)
            self.keep(record, numbers, notes)
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()
            dist.destroy_process_group()
        if result is not None:
            guard.check("before the result")
            log(f"portbench: {len(times)} calls in {window_s:.3f} s, "
                f"{sum(conv)} of {len(times) * B} scenarios converged; "
                f"peak memory {max(peaks)} B on the fullest card")
            for line in notes:
                log(f"portbench: {line}")
            log(smi())
            print(json.dumps(result), flush=True)
            for name, (value, limit) in numbers.items():
                log(f"check {name} {value!r} limit {limit!r}")
            log(f"check correct {result['correct']}")
        return 0

    def result(self, record, device, ok, numbers, converged, attempted):
        kind = "per_layer" if self.args.trace else "end_to_end"
        metrics = {}
        for m in getattr(self.cell, kind):
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out = {"correct": bool(ok), "attempted": attempted,
               "failed": attempted - converged, "metrics": metrics,
               "device": device}
        if self.args.trace:
            out["breakdown"] = breakdown(record)
        out["checks"] = {name: {"value": v, "limit": lim}
                         for name, (v, lim) in numbers.items()}
        return out

    def keep(self, record, numbers, notes):
        """Per-call times and counts, kept under the checkout."""
        os.makedirs(OUT_DIR, exist_ok=True)
        name = (f"{self.cell.name}.seed{self.args.seed}."
                f"trace{self.args.trace}.json")
        keep = {k: v for k, v in record.items() if k != "device"}
        if record["device"] is not None:
            keep["device"] = {k: (v if k != "launches" else
                                  {f"{a}{list(b)}": c
                                   for (a, b), c in v.items()})
                              for k, v in record["device"].items()}
        keep["checks"] = numbers
        keep["notes"] = notes
        with open(os.path.join(OUT_DIR, name), "w") as fh:
            json.dump(keep, fh)


def breakdown(record) -> dict:
    """The ten device operations that took most time (device segment) and
    the ten largest sums of idle time by what the host was doing (span
    segment), in seconds."""
    top = lambda d: [[k, v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    out = {"device_ops": top(record["device"]["by_name"])}
    if record["spans"] is not None:
        out["idle_gaps"] = top(record["spans"]["idle_by_host"])
    return out


def smi() -> str:
    """The card's name, power limit and clocks, from ``nvidia-smi``."""
    try:
        return "nvidia-smi: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() \
            .replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: not read ({e})"
