"""Per-iteration trajectory logs in the reference's interchange format
(the port of :mod:`hpfx.trajlog`): pandas ``orient="table"`` JSON,
``V_log.json`` rows {iteration, harmonic, bus, V_m, V_a} and single-device
``I_log.json`` rows {iteration, harmonic, "0": re, "1": im}, numbers
rounded to 10 decimals.  The writers take tensors on any device (or
numpy arrays) and write the same bytes as the JAX package's writers on
the same trajectory; the readers return numpy arrays.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_VLOG_SCHEMA = {
    "fields": [
        {"name": "iteration", "type": "integer"},
        {"name": "harmonic", "type": "integer"},
        {"name": "bus", "type": "string"},
        {"name": "V_m", "type": "number"},
        {"name": "V_a", "type": "number"},
    ],
    "primaryKey": ["iteration", "harmonic", "bus"],
    "pandas_version": "0.20.0",
}

_ILOG_SCHEMA = {
    "fields": [
        {"name": "iteration", "type": "integer"},
        {"name": "harmonic", "type": "integer"},
        {"name": 0, "type": "number"},
        {"name": 1, "type": "number"},
    ],
    "primaryKey": ["iteration", "harmonic"],
    "pandas_version": "0.20.0",
}


def _r10(x: float) -> float:
    return round(float(x), 10)


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_vlog(path: str, trajectory, harmonics: Sequence[int],
               n_iter: Optional[int] = None) -> int:
    """Write an hpfx trajectory as a reference-format ``V_log.json``.

    ``trajectory``: (T, 2, H, n) array — axis 1 is (V_m, V_a) — as produced
    by ``solve_harmonic(record_trajectory=True)`` (row 0 is the
    post-fundamental initial state, row t the state after NR iteration t,
    NaN-padded past the converged iteration).  ``harmonics``: the harmonic
    orders (Settings.harmonics).  ``n_iter``: keep rows 0..n_iter; by
    default NaN-padded rows are dropped.  Buses are named ``bus1..busN``
    (the reference's 1-based naming).  Returns the number of iterations
    written.
    """
    traj = _host(trajectory)
    if traj.ndim != 4 or traj.shape[1] != 2:
        raise ValueError(f"trajectory must be (T, 2, H, n), got {traj.shape}")
    T, _, H, n = traj.shape
    if len(harmonics) != H:
        raise ValueError(
            f"harmonics has {len(harmonics)} entries for H={H} trajectory")
    # clamp to the last valid (non-NaN) row even when an explicit n_iter
    # overshoots: serializing NaN would emit bare `NaN` tokens (json's
    # allow_nan default), which strict parsers — including the reference
    # side's pandas read_json — reject
    valid = ~np.isnan(traj).any(axis=(1, 2, 3))
    T_valid = int(np.max(np.nonzero(valid)[0])) + 1 if valid.any() else 0
    if n_iter is None:
        T_out = T_valid
    else:
        T_out = min(int(n_iter) + 1, T, T_valid)
    rows = []
    for it in range(T_out):
        for hi, h in enumerate(harmonics):
            for b in range(n):
                rows.append({
                    "iteration": it, "harmonic": int(h),
                    "bus": f"bus{b + 1}",
                    "V_m": _r10(traj[it, 0, hi, b]),
                    "V_a": _r10(traj[it, 1, hi, b]),
                })
    with open(path, "w") as fh:
        json.dump({"schema": _VLOG_SCHEMA, "data": rows}, fh,
                  separators=(",", ":"))
    return T_out


def read_vlog(path: str) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
    """Read a ``V_log.json`` (reference- or hpfx-written).

    Returns ``(V_m (T, H, n), V_a (T, H, n), harmonics)`` with iterations,
    harmonics, and buses sorted ascending (buses by their numeric suffix).
    Missing entries (absent from the log) read as NaN.
    """
    d = json.load(open(path))
    data = d["data"]
    iters = sorted({r["iteration"] for r in data})
    harms = sorted({r["harmonic"] for r in data})
    buses = sorted({r["bus"] for r in data}, key=lambda s: int(s[3:]))
    it_ix = {v: i for i, v in enumerate(iters)}
    h_ix = {v: i for i, v in enumerate(harms)}
    b_ix = {v: i for i, v in enumerate(buses)}
    V_m = np.full((len(iters), len(harms), len(buses)), np.nan)
    V_a = np.full_like(V_m, np.nan)
    for r in data:
        i, h, b = it_ix[r["iteration"]], h_ix[r["harmonic"]], b_ix[r["bus"]]
        V_m[i, h, b] = r["V_m"]
        V_a[i, h, b] = r["V_a"]
    return V_m, V_a, tuple(harms)


def write_ilog(path: str, injections, harmonics: Sequence[int]) -> int:
    """Write a single-device injection trace as reference-format
    ``I_log.json``: ``injections`` is (T, H) complex (or a (T, H) Cx
    ``.to_numpy()``), rows {iteration, harmonic, "0": Re, "1": Im}."""
    inj = _host(injections)
    if inj.ndim != 2:
        raise ValueError(f"injections must be (T, H), got {inj.shape}")
    T, H = inj.shape
    if len(harmonics) != H:
        raise ValueError(
            f"harmonics has {len(harmonics)} entries for H={H} injections")
    rows = []
    for it in range(T):
        if np.isnan(inj[it]).any():
            break
        for hi, h in enumerate(harmonics):
            rows.append({
                "iteration": it, "harmonic": int(h),
                "0": _r10(inj[it, hi].real), "1": _r10(inj[it, hi].imag),
            })
    n_written = rows[-1]["iteration"] + 1 if rows else 0
    with open(path, "w") as fh:
        json.dump({"schema": _ILOG_SCHEMA, "data": rows}, fh,
                  separators=(",", ":"))
    return n_written


def trajectory_injections(trajectory, devices, m: int) -> np.ndarray:
    """Per-iteration device injections of a recorded (T, 2, H, n)
    trajectory (``solve_harmonic(record_trajectory=True)``), evaluated on
    the devices' device: complex (T_valid, n_nl, H); pass ``out[:, d, :]``
    of one device to :func:`write_ilog`."""
    from . import cx as _cx
    from .devices import DeviceSet
    from .harmonic import current_injections

    dv = devices.I_N.device if isinstance(devices, DeviceSet) else None
    traj = torch.as_tensor(trajectory, device=dv)
    rows = []
    for t in range(traj.shape[0]):
        if bool(torch.isnan(traj[t]).any()):
            break
        V_m, V_a = traj[t, 0], traj[t, 1]
        I = current_injections(_cx.polar(V_m, V_a), devices, m, V_m, V_a)
        rows.append(_host(I.re) + 1j * _host(I.im))
    return np.stack(rows) if rows else np.zeros((0, 0, 0), complex)


def read_ilog(path: str) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Read an ``I_log.json`` -> (injections (T, H) complex, harmonics)."""
    d = json.load(open(path))
    data = d["data"]
    iters = sorted({r["iteration"] for r in data})
    harms = sorted({r["harmonic"] for r in data})
    it_ix = {v: i for i, v in enumerate(iters)}
    h_ix = {v: i for i, v in enumerate(harms)}
    inj = np.full((len(iters), len(harms)), np.nan, complex)
    for r in data:
        inj[it_ix[r["iteration"]], h_ix[r["harmonic"]]] = \
            r["0"] + 1j * r["1"]
    return inj, tuple(harms)
