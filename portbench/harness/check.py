"""Whether the timed calls answered right: every sampled answer against the
plain float64 reference (``portbench/reference/hpf_ref.py``).

Each call of the window gives up the answers (``V_m``, ``V_a`` over
every harmonic and bus, the converged flag and the Newton trips) of its
sampled lanes: lanes drawn from the seed and the lanes that took the
most trips, where the host's rescue lands.  The window's slowest calls,
which the rescue makes slow, give up every lane.  Each answer comes
with the scales the benchmark drew for it.  After the window, with the
program's results freed, the reference solves the same scenarios from
the network and device tables in blocks, and the number compared is

- ``dv_max_pu``: the largest phasor gap |V_m e^{j V_a} - V_ref| over
  every sampled answer, harmonic and bus (per unit), an answer returned
  unconverged included; a non-finite answer reads infinite.

The cell's file gives its limit.  A window with no sampled answer, or a
reference that does not converge, is not correct.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
from reference import hpf_ref

from . import spec

#: bytes the reference's Jacobians may take at once
BLOCK_BYTES = 1 << 30


class Sample(NamedTuple):
    """Sampled answers of one call, on the host."""
    p: torch.Tensor          # (k,) float32 scales as drawn
    q: torch.Tensor
    s: torch.Tensor
    V_m: torch.Tensor        # (k, H, n)
    V_a: torch.Tensor
    converged: torch.Tensor  # (k,) bool
    n_iter: torch.Tensor     # (k,) Newton trips


def lanes(result, drawn: torch.Tensor, stragglers: int) -> torch.Tensor:
    """The lanes a call gives up: ``drawn`` and the ``stragglers`` lanes
    of the batch-major ``result`` that took the most trips, sorted, on
    the host."""
    k = min(stragglers, result.n_iter.shape[0])
    top = torch.topk(result.n_iter, k).indices.cpu()
    return torch.unique(torch.cat([drawn.cpu(), top]))


def take(result, lanes: torch.Tensor, scales: dict) -> Sample:
    """The answers of ``lanes`` of a batch-major result, copied to the
    host."""
    idx = lanes.to(result.V_m.device)
    return Sample(scales["p_scale"][lanes], scales["q_scale"][lanes],
                  scales["injection_scale"][lanes],
                  result.V_m[idx].cpu(), result.V_a[idx].cpu(),
                  result.converged[idx].cpu(), result.n_iter[idx].cpu())


def problem(config: dict, h_max: int, root: str = spec.ROOT):
    """The reference's problem of a configuration at harmonic depth
    ``h_max``, read from its tables."""
    st = config["settings"]
    path = lambda p: os.path.join(root, p)
    grid = hpf_ref.read_grid(path(config["buses"]), path(config["lines"]),
                             st["base_power"], st["base_voltage"])
    return hpf_ref.problem(grid, list(range(1, h_max + 1, 2)),
                           path(config["device_tables"]), st["net_freq"],
                           st["base_power"], st["base_voltage"])


def _block(pb) -> int:
    dim = 2 * (pb.H * pb.n - 1)
    return max(1, min(4096, BLOCK_BYTES // (3 * 8 * dim * dim)))


def solve_reference(pb, p, q, s, device, prec=hpf_ref.FLOAT64):
    """The reference's V (b, H, n) complex128 for the scales, in blocks,
    and its largest residual."""
    out, worst = [], 0.0
    B = _block(pb)
    for lo in range(0, p.shape[0], B):
        sl = slice(lo, lo + B)
        V, res, _ = hpf_ref.solve(pb, p[sl].double(), q[sl].double(),
                                  s[sl].double(), prec, device)
        out.append(V.to(torch.complex128).cpu())
        worst = max(worst, float(res.max()))
    return torch.cat(out), worst


def phasor_gap(V_m, V_a, V_ref) -> torch.Tensor:
    """max over harmonics and buses of |V_m e^{j V_a} - V_ref| per answer
    (inf where the answer is not finite)."""
    V = torch.polar(V_m.double(), V_a.double())
    gap = (V - V_ref).abs().flatten(1).amax(dim=1)
    finite = torch.isfinite(V_m).flatten(1).all(1) \
        & torch.isfinite(V_a).flatten(1).all(1)
    return torch.where(finite, gap, torch.full_like(gap, math.inf))


#: the reference's largest residual entry above which it counts as not
#: converged (per unit)
REFERENCE_RESIDUAL = 1e-8


def judge(samples, pb, limits: dict, device, budget: int = None) -> tuple:
    """(correct, {name: (value, limit)}, notes) for the sampled answers;
    ``budget``, the settings' Newton trips, counts the answers that took
    more: those a restart or the host's rescue solved again."""
    if not samples:
        return False, {}, ["no call completed in the window"]
    cat = lambda f: torch.cat([getattr(x, f) for x in samples])
    V_ref, worst = solve_reference(pb, cat("p"), cat("q"), cat("s"),
                                   device)
    gap = phasor_gap(cat("V_m"), cat("V_a"), V_ref)
    numbers = {"dv_max_pu": (float(gap.max()), float(limits["dv_max_pu"]))}
    notes = [f"{gap.numel()} sampled answers, {int((~cat('converged')).sum())}"
             f" returned unconverged; reference residual {worst:.3e}"]
    if budget is not None:
        past = cat("n_iter") > budget
        gp = float(gap[past].max()) if bool(past.any()) else None
        notes.append(f"{int(past.sum())} sampled answers took more than "
                     f"the {budget} trips of the settings (restarted or "
                     f"rescued), "
                     f"largest gap {gp}")
    ok = all(v <= lim for v, lim in numbers.values())
    if not worst <= REFERENCE_RESIDUAL:
        ok = False
        notes.append(f"the reference did not converge (residual {worst})")
    return ok, numbers, notes
