"""Network data model: buses, lines, per-unit conversion.

The PyTorch counterpart of :mod:`hpfx.network`: the same two CSV schemas
(net2/net3 ``X_sh`` with line G/B; net1 ``X_shunt`` without them), the
same per-unit conversion and the same bus-ordering contract (slack, PV,
PQ, nonlinear).  Numeric fields are tensors on the device the loader is
given, the CUDA card by default; ``n``/``m``/``c``/``bus_types``/
``components`` are plain Python.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .config import Settings

# bus type codes
SLACK, PV, PQ, NONLINEAR = 0, 1, 2, 3
_TYPE_CODES = {"slack": SLACK, "PV": PV, "PQ": PQ, "nonlinear": NONLINEAR}

#: tensor fields of :class:`Network`, in declaration order
ARRAY_FIELDS = ("bus_P", "bus_Q", "bus_S", "bus_Xsh", "line_from", "line_to",
                "line_R", "line_X", "line_G", "line_B", "line_tau",
                "line_shift")


@dataclasses.dataclass(frozen=True)
class Network:
    """Static grid description in per-unit (see ``hpfx.network.Network``).

    ``m`` is the index of the first nonlinear bus, ``c`` the number of PV
    buses plus one (slack)."""

    bus_P: torch.Tensor
    bus_Q: torch.Tensor
    bus_S: torch.Tensor
    bus_Xsh: torch.Tensor
    line_from: torch.Tensor      # 0-based bus indices (int64)
    line_to: torch.Tensor
    line_R: torch.Tensor
    line_X: torch.Tensor
    line_G: torch.Tensor
    line_B: torch.Tensor
    line_tau: torch.Tensor
    line_shift: torch.Tensor     # radians

    n: int
    m: int
    c: int
    bus_types: Tuple[int, ...]
    components: Tuple[str, ...]

    @property
    def device(self) -> torch.device:
        return self.bus_P.device

    @property
    def n_lines(self) -> int:
        return self.line_R.shape[0]

    @property
    def n_nonlinear(self) -> int:
        return self.n - self.m

    @property
    def nonlinear_components(self) -> Tuple[str, ...]:
        return self.components[self.m:]

    def to(self, device=None, dtype=None) -> "Network":
        """Copy with every tensor moved to ``device`` and every floating
        tensor cast to ``dtype``."""
        def mv(t):
            return t.to(device=device,
                        dtype=dtype if t.is_floating_point() else None)
        return dataclasses.replace(
            self, **{k: mv(getattr(self, k)) for k in ARRAY_FIELDS})


def _read_semicolon_csv(path: str):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter=";"))


def _f(row, key, default=None) -> float:
    if key in row and row[key] not in (None, ""):
        return float(row[key])
    if default is None:
        raise KeyError(f"missing required column {key!r}")
    return float(default)


def load_network(buses_csv: str, lines_csv: str, settings: Settings,
                 sort: bool = False, validate: bool = True,
                 device=None) -> Network:
    """Load a network from the reference ``;``-delimited CSV schemas
    (``hpfx.network.load_network``) onto ``device`` (default: the CUDA
    card, :func:`hpfx_torch._device.resolve_device`)."""
    bus_rows = _read_semicolon_csv(buses_csv)
    line_rows = _read_semicolon_csv(lines_csv)
    types = [_TYPE_CODES[r["type"]] for r in bus_rows]
    if sort:
        order = np.argsort(types, kind="stable")
        bus_rows = [bus_rows[i] for i in order]
        types = [types[i] for i in order]
    if list(types) != sorted(types):
        raise ValueError(
            "buses must be ordered slack, PV, PQ, nonlinear "
            "(pass sort=True to reorder automatically)")

    id_to_idx = {int(float(r["ID"])): i for i, r in enumerate(bus_rows)}
    bp = settings.base_power
    zb = settings.base_impedance
    yb = settings.base_admittance

    arrays = dict(
        bus_P=[_f(r, "P") / bp for r in bus_rows],
        bus_Q=[_f(r, "Q") / bp for r in bus_rows],
        bus_S=[_f(r, "S", 0.0) / bp for r in bus_rows],
        bus_Xsh=[_f(r, "X_sh", r.get("X_shunt", 0.0)) / zb
                 for r in bus_rows],
        line_from=[id_to_idx[int(float(r["fromID"]))] for r in line_rows],
        line_to=[id_to_idx[int(float(r["toID"]))] for r in line_rows],
        line_R=[_f(r, "R") / zb for r in line_rows],
        line_X=[_f(r, "X") / zb for r in line_rows],
        line_G=[_f(r, "G", 0.0) / yb for r in line_rows],
        line_B=[_f(r, "B", 0.0) / yb for r in line_rows],
        line_tau=[_f(r, "tau", 1.0) for r in line_rows],
        line_shift=[_f(r, "phase_shift", 0.0) * np.pi / 180.0
                    for r in line_rows])
    components = tuple(r["component"] for r in bus_rows)
    net = _make_network(arrays, tuple(types), components, settings, device)
    if validate:
        validate_network(net)
    return net


def network_from_arrays(*, bus_types: Sequence[int],
                        components: Sequence[str], P, Q, S=None, X_sh=None,
                        line_from, line_to, R, X, G=None, B=None, tau=None,
                        phase_shift=None, settings: Settings,
                        per_unit: bool = True, device=None) -> Network:
    """Programmatic constructor (``hpfx.network.network_from_arrays``) onto
    ``device`` (default: the CUDA card).  ``line_from``/``line_to`` are 0-based bus indices and
    ``phase_shift`` is in degrees.  If ``per_unit`` is False, quantities are
    converted with the settings' bases, as the CSV loader does."""
    nb, nl = len(P), len(R)
    f = lambda a, k: np.full(k, 0.0) if a is None else np.asarray(a, float)
    P, Q, S, X_sh = f(P, nb), f(Q, nb), f(S, nb), f(X_sh, nb)
    R, X, G, B = f(R, nl), f(X, nl), f(G, nl), f(B, nl)
    tau = np.ones(nl) if tau is None else np.asarray(tau, float)
    shift = f(phase_shift, nl) * np.pi / 180.0
    if not per_unit:
        P, Q, S = (v / settings.base_power for v in (P, Q, S))
        X_sh = X_sh / settings.base_impedance
        R, X = R / settings.base_impedance, X / settings.base_impedance
        G, B = G / settings.base_admittance, B / settings.base_admittance
    arrays = dict(bus_P=P, bus_Q=Q, bus_S=S, bus_Xsh=X_sh,
                  line_from=np.asarray(line_from, int),
                  line_to=np.asarray(line_to, int), line_R=R, line_X=X,
                  line_G=G, line_B=B, line_tau=tau, line_shift=shift)
    return _make_network(arrays, tuple(int(t) for t in bus_types),
                         tuple(components), settings, device)


def validate_network(net: Network) -> None:
    """Structural checks (``hpfx.network.validate_network``): every bus
    reachable from the slack, endpoints in range, no self-loops, positive
    series impedances."""
    f = net.line_from.cpu().numpy()
    t = net.line_to.cpu().numpy()
    if f.size and (f.min() < 0 or t.min() < 0 or
                   f.max() >= net.n or t.max() >= net.n):
        raise ValueError("line endpoint out of range")
    if np.any(f == t):
        raise ValueError("self-loop line")
    z2 = net.line_R.cpu().numpy() ** 2 + net.line_X.cpu().numpy() ** 2
    if np.any(z2 <= 0):
        raise ValueError("line with zero series impedance")
    seen = {0}
    frontier = [0]
    adj = {}
    for a, b in zip(f.tolist(), t.tolist()):
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    while frontier:
        u = frontier.pop()
        for v in adj.get(u, ()):
            if v not in seen:
                seen.add(v)
                frontier.append(v)
    if len(seen) != net.n:
        missing = sorted(set(range(net.n)) - seen)
        raise ValueError(f"buses unreachable from the slack: {missing}")


def _make_network(arrays, types: Tuple[int, ...], components: Tuple[str, ...],
                  settings: Settings, device) -> Network:
    n = len(arrays["bus_P"])
    nl_idx = [i for i, t in enumerate(types) if t == NONLINEAR]
    m = min(nl_idx) if nl_idx else n          # hcne_generalized.py:122-125
    c = sum(1 for t in types if t == PV) + 1  # hcne_generalized.py:127
    rd = settings.real_dtype
    device = resolve_device(device)

    def as_t(k):
        dt = torch.int64 if k in ("line_from", "line_to") else rd
        return torch.as_tensor(np.asarray(arrays[k]), dtype=dt, device=device)

    return Network(**{k: as_t(k) for k in ARRAY_FIELDS},
                   n=n, m=m, c=c, bus_types=types, components=components)
