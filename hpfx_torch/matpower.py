"""MATPOWER case-file import (``.m`` format), the port of
:mod:`hpfx.matpower`: :func:`parse_matpower` reads the ``mpc.baseMVA`` /
``mpc.bus`` / ``mpc.gen`` / ``mpc.branch`` matrices (MATPOWER manual §B)
into numpy on the host, and :func:`load_matpower` maps them onto
:class:`hpfx_torch.network.Network` on the device, with the JAX package's
mapping: bus load PD − ΣPG (hpfx's sign: load positive), buses stably
re-sorted to slack, PV, PQ, nonlinear with the branch ends remapped,
``nonlinear={bus_id: component}`` for device buses, BS as the harmonic
shunt X_sh = −1/BS_pu (GS ignored, with a warning), TAP = 0 as 1.0,
out-of-service branches dropped, and ``slack_xsh`` grounding the
harmonic network at the reference bus.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, Optional

import numpy as np

from .config import Settings
from .network import (NONLINEAR, PQ, PV, SLACK, Network,
                      network_from_arrays, validate_network)

__all__ = ["parse_matpower", "load_matpower"]

# MATPOWER column indices (manual §B.1-B.3)
_BUS_I, _BUS_TYPE, _PD, _QD, _GS, _BS = 0, 1, 2, 3, 4, 5
_GEN_BUS, _PG, _QG = 0, 1, 2
_GEN_VG, _GEN_STATUS = 5, 7
_F_BUS, _T_BUS, _BR_R, _BR_X, _BR_B = 0, 1, 2, 3, 4
_TAP, _SHIFT, _BR_STATUS = 8, 9, 10

_TYPE_MAP = {3: SLACK, 2: PV, 1: PQ}


def _strip_comments(text: str) -> str:
    # remove %-comments (MATPOWER files do not use % inside strings in
    # the data sections we read)
    return re.sub(r"%[^\n]*", "", text)


def parse_matpower(path: str) -> Dict[str, np.ndarray]:
    """Parse a MATPOWER case file into ``{"baseMVA": float, "bus": (nb, *),
    "gen": (ng, *), "branch": (nl, *)}`` numpy matrices (raw, unconverted).
    """
    with open(path) as fh:
        text = _strip_comments(fh.read())
    out: Dict[str, np.ndarray] = {}
    m = re.search(r"mpc\.baseMVA\s*=\s*([0-9eE.+-]+)\s*;", text)
    if not m:
        raise ValueError(f"{path}: no mpc.baseMVA — not a MATPOWER case?")
    out["baseMVA"] = float(m.group(1))
    for name in ("bus", "gen", "branch"):
        m = re.search(rf"mpc\.{name}\s*=\s*\[(.*?)\]\s*;", text, re.S)
        if not m:
            if name == "gen":
                out[name] = np.zeros((0, 10))
                continue
            raise ValueError(f"{path}: missing mpc.{name} matrix")
        rows = []
        for line in m.group(1).replace(";", "\n").splitlines():
            vals = line.split()
            if vals:
                rows.append([float(v) for v in vals])
        if rows and min(len(r) for r in rows) != max(len(r) for r in rows):
            raise ValueError(f"{path}: ragged mpc.{name} matrix")
        out[name] = np.asarray(rows, float)
    return out


def load_matpower(path: str, settings: Settings, *,
                  nonlinear: Optional[Dict[int, str]] = None,
                  slack_xsh: Optional[float] = None,
                  validate: bool = True, device=None) -> Network:
    """Load a MATPOWER case as a :class:`hpfx_torch.network.Network` on
    ``device`` (default: the CUDA card).

    ``nonlinear`` maps MATPOWER bus IDs to component names (the names
    :func:`hpfx_torch.load_device_set` resolves against the NE tables); those
    buses become type-``nonlinear`` regardless of their MATPOWER type.

    ``slack_xsh`` (pu) grounds the harmonic network at the reference
    bus — the upstream grid's short-circuit (Thevenin) reactance, the
    role of the slack's ``X_sh`` column in the reference nets
    (``hpfx/data/net2_buses.csv``).  MATPOWER carries no equivalent; a
    case imported WITHOUT it (and without ``BS`` shunts) leaves the
    harmonic subsystem nearly floating and harmonic NR typically
    diverges — a warning is emitted when nonlinear buses are present.

    See the module docstring for the full mapping contract.
    """
    mpc = parse_matpower(path)
    base = mpc["baseMVA"]
    bus, gen, br = mpc["bus"], mpc["gen"], mpc["branch"]
    nonlinear = dict(nonlinear or {})

    ids = bus[:, _BUS_I].astype(int)
    if len(set(ids.tolist())) != len(ids):
        raise ValueError("duplicate bus IDs in mpc.bus")
    unknown = set(nonlinear) - set(ids.tolist())
    if unknown:
        raise ValueError(f"nonlinear= references unknown bus IDs {sorted(unknown)}")

    # net load per bus: PD - sum(PG of in-service gens)
    P = bus[:, _PD].copy()
    Q = bus[:, _QD].copy()
    id_to_row = {int(i): k for k, i in enumerate(ids)}
    for g in gen:
        if g.shape[0] > _GEN_STATUS and g[_GEN_STATUS] <= 0:
            continue
        k = id_to_row.get(int(g[_GEN_BUS]))
        if k is None:
            raise ValueError(f"mpc.gen references unknown bus {int(g[_GEN_BUS])}")
        P[k] -= g[_PG]
        Q[k] -= g[_QG]
        if g.shape[0] > _GEN_VG and abs(g[_GEN_VG] - 1.0) > 1e-9:
            warnings.warn(
                f"generator at bus {int(g[_GEN_BUS])} sets VG="
                f"{g[_GEN_VG]:.4f}; the solver fixes slack/PV magnitudes "
                "at 1.0 pu", stacklevel=2)

    types = np.empty(len(ids), int)
    for k, t in enumerate(bus[:, _BUS_TYPE].astype(int)):
        if int(ids[k]) in nonlinear:
            types[k] = NONLINEAR
            continue
        if t not in _TYPE_MAP:
            raise ValueError(f"bus {int(ids[k])}: unsupported MATPOWER "
                             f"type {t} (isolated?)")
        types[k] = _TYPE_MAP[t]

    if np.any(bus[:, _GS] != 0.0):
        warnings.warn("mpc.bus GS (shunt conductance) has no hpfx "
                      "counterpart and is ignored", stacklevel=2)
    bs = bus[:, _BS] / base                      # pu admittance at V=1
    X_sh = np.where(bs != 0.0, -1.0 / np.where(bs != 0.0, bs, 1.0), 0.0)
    if np.any(bs != 0.0):
        warnings.warn(
            "mpc.bus BS mapped to X_sh=-1/BS_pu: enters harmonic rows "
            "only (the h=1 power flow carries no bus shunt, "
            "hcne_generalized.py:157-161)", stacklevel=2)

    # stable re-sort to slack, PV, PQ, nonlinear; remap branch endpoints
    order = np.argsort(types, kind="stable")
    inv = {int(ids[o]): k for k, o in enumerate(order)}
    types_s = types[order]
    if not np.any(types_s == SLACK):
        raise ValueError("no reference (type-3) bus in mpc.bus")

    slack_rows = np.flatnonzero(types == SLACK)
    if slack_xsh is not None:
        X_sh[slack_rows] = float(slack_xsh)
    elif nonlinear and np.all(X_sh[slack_rows] == 0.0):
        warnings.warn(
            "no slack_xsh given and the reference bus carries no shunt: "
            "the harmonic network is ungrounded upstream and harmonic "
            "NR will likely diverge — pass slack_xsh=<grid short-circuit "
            "reactance in pu> (the slack X_sh column of the reference "
            "nets)", stacklevel=2)

    components = []
    for o in order:
        bid = int(ids[o])
        if bid in nonlinear:
            components.append(str(nonlinear[bid]))
        elif types[o] == SLACK:
            components.append("generator")
        elif types[o] == PV:
            components.append(f"gen_{bid}")
        else:
            components.append(f"load_{bid}")

    live = np.ones(len(br), bool)
    if br.shape[1] > _BR_STATUS:
        live = br[:, _BR_STATUS] > 0
    br = br[live]
    f_idx = np.array([inv[int(b)] for b in br[:, _F_BUS]])
    t_idx = np.array([inv[int(b)] for b in br[:, _T_BUS]])
    tap = br[:, _TAP] if br.shape[1] > _TAP else np.zeros(len(br))
    tap = np.where(tap == 0.0, 1.0, tap)
    shift = br[:, _SHIFT] if br.shape[1] > _SHIFT else np.zeros(len(br))

    net = network_from_arrays(
        bus_types=tuple(int(t) for t in types_s),
        components=tuple(components),
        P=P[order] / base, Q=Q[order] / base,
        X_sh=X_sh[order],
        line_from=f_idx, line_to=t_idx,
        R=br[:, _BR_R], X=br[:, _BR_X], B=br[:, _BR_B],
        tau=tap, phase_shift=shift,
        settings=settings, per_unit=True, device=device)
    if validate:
        validate_network(net)
    return net
