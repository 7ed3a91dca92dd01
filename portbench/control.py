"""The control of the benchmark's check, and the witnesses of its limits.

    python3 portbench/control.py --workload <cell> --seed <n> --calls <k> \
        [--as tf32|float32|port64]

Draws the sampled lanes of the first ``k`` calls of a run with that seed
(the window's scenarios, ``harness/traffic.py``), answers them in the
program's place, and judges the answers with the check itself
(``harness/check.py``'s ``judge``: the float64 reference, the cell's
limits).  What answers them:

- ``tf32`` (the default), the control: the reference computed one
  precision below the configuration's float32, in float32 with TF32
  matrix products (``reference/hpf_ref.py``'s ``TF32``).  It must come
  out as not correct.
- ``float32``, a witness: the reference in plain float32, TF32 off, the
  configuration's own precision: float32's own error at the cell's depth.
- ``port64``, a witness: the cell's sweep entry in float64, converged to
  the reference test's thresholds, on the same scenarios in one call:
  how near the port comes to the reference when float32 is out of the
  way.

Prints one JSON line: ``correct``, each number beside its limit, and the
check's notes.  Runs on the first CUDA card, or on the CPU where there
is none; the benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import torch  # noqa: E402

from harness import check, guard, spec, traffic  # noqa: E402
from reference import hpf_ref  # noqa: E402

PRECISIONS = {"tf32": hpf_ref.TF32,
              "float32": hpf_ref.Precision(torch.float32)}


def _port64(cell, p, q, s, device):
    """The cell's entry in float64 on the scenarios: V (b, H, n) complex128
    and the converged flags."""
    import hpfx_torch as ht
    if device.type == "cuda":
        from hpfx_torch.ops import _build
        _build.load_library()
    cfg = cell.config
    st = ht.settings_for_hmax(int(cell.traffic["h_max"]),
                              **dict(cfg["settings"], dtype="float64"),
                              thresh_h=1e-10, thresh_f=1e-12)
    path = lambda f: os.path.join(spec.ROOT, f)
    net = ht.load_network(path(cfg["buses"]), path(cfg["lines"]), st,
                          device=device)
    dev = ht.load_device_set(net, st,
                             search_dirs=(path(cfg["device_tables"]),))
    call = spec.entry(cell.entry).make(net, dev, st, cell.workload["args"], 1)
    put = lambda x: x.double().to(device)
    r = call(ht.Scenarios(put(p), put(q), put(s)))
    return torch.polar(r.V_m.double(), r.V_a.double()).cpu(), \
        r.converged.cpu()


def readings(cell, seed: int, calls: int, device, what: str = "tf32"):
    """(correct, {number: (reading, limit)}, notes) of ``what`` in the
    program's place on the sampled lanes of ``calls`` calls."""
    k = int(cell.workload["sample_per_call"])
    draws = [traffic.draw(cell.traffic, seed, i, k) for i in range(calls)]
    pick = lambda name: torch.cat([b.scales[name][b.sample] for b in draws])
    p, q, s = pick("p_scale"), pick("q_scale"), pick("injection_scale")
    pb = check.problem(cell.config, int(cell.traffic["h_max"]))
    if what == "port64":
        V, conv = _port64(cell, p, q, s, device)
    else:
        V, _ = check.solve_reference(pb, p, q, s, device, PRECISIONS[what])
        conv = torch.ones(V.shape[0], dtype=torch.bool)
    n_iter = torch.zeros(V.shape[0], dtype=torch.int64)
    answers = check.Sample(p, q, s, V.abs(), V.angle(), conv, n_iter)
    return check.judge([answers], pb, cell.workload["limits"], device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--as", dest="what", default="tf32",
                    choices=(*PRECISIONS, "port64"))
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    ok, numbers, notes = readings(cell, args.seed, args.calls, device,
                                  args.what)
    guard.check("control")
    print(json.dumps({"correct": ok, "as": args.what, "numbers": numbers,
                      "notes": notes, "cell": cell.name, "seed": args.seed,
                      "calls": args.calls, "device": str(device),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
