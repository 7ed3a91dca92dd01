"""Nonlinear devices as stacked Norton equivalents.

The PyTorch counterpart of the Norton part of :mod:`hpfx.devices`: the
``<device>_NE.csv`` reader, per-unit conversion, the case-insensitive
file lookup and the stacked :class:`DeviceSet` — ``I_N (n_nl, H)`` and
``Y_N (n_nl, H, H)`` coupled or ``(n_nl, H)`` uncoupled.  The NE tables
are read in place from the JAX package's data directory, by path.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network

#: the NE tables shipped with the repository (shared with the JAX package)
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "hpfx", "data")


@dataclasses.dataclass(frozen=True)
class DeviceSet:
    """Norton equivalents of all nonlinear buses of a network, stacked:
    ``I_N[k]``/``Y_N[k]`` belong to bus ``m + k``.  A scaled set
    (:meth:`scale`) may carry leading scenario axes."""

    I_N: Cx
    Y_N: Cx
    coupled: bool

    @property
    def n_devices(self) -> int:
        return self.I_N.shape[-2]

    def scale(self, factor) -> "DeviceSet":
        """Scale injections: I_N and Y_N together
        (``hpfx.devices.DeviceSet.scale``).  ``factor`` is a scalar, or
        its last axis runs over the devices (n_nl, or 1 for all of them)
        and its leading axes, if any, are scenarios, which the result then
        carries in front of I_N (..., n_nl, H) and Y_N."""
        f = torch.as_tensor(factor, dtype=self.I_N.dtype,
                            device=self.I_N.device)
        if f.dim() == 0:
            return dataclasses.replace(self, I_N=self.I_N * f,
                                       Y_N=self.Y_N * f)
        fY = f[..., None, None] if self.coupled else f[..., None]
        return dataclasses.replace(self, I_N=self.I_N * f[..., None],
                                   Y_N=self.Y_N * fY)

    def to(self, device=None, dtype=None) -> "DeviceSet":
        kw = dict(device=device, dtype=dtype)
        return dataclasses.replace(self, I_N=self.I_N.to(**kw),
                                   Y_N=self.Y_N.to(**kw))


def _parse_complex(s: str) -> complex:
    return complex(s.strip().strip("()"))


def read_ne_csv(path: str) -> Dict:
    """Parse a ``<device>_NE.csv`` table into raw (SI-unit) numpy arrays:
    ``freqs``, ``y_row_freqs``, ``Y_c`` (F, F), ``I_c``, ``Y_uc``, ``I_uc``."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    freqs = [int(float(col)) for col in rows[0][2:]]
    y_c: Dict[int, np.ndarray] = {}
    vecs: Dict[str, np.ndarray] = {}
    for row in rows[1:]:
        param, freq = row[0], int(float(row[1]))
        vals = np.array([_parse_complex(v) for v in row[2:]])
        if param == "Y_N_c":
            y_c[freq] = vals
        else:
            vecs[param] = vals
    Y_c = np.stack([y_c[f] for f in sorted(y_c)])
    return dict(freqs=freqs, y_row_freqs=sorted(y_c), Y_c=Y_c,
                I_c=vecs["I_N_c"], Y_uc=vecs["Y_N_uc"], I_uc=vecs["I_N_uc"])


def load_norton_equivalent(path: str, settings: Settings, coupled: bool
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One device's NE sliced to the considered harmonics, in per-unit:
    (I_N (H,), Y_N (H, H) or (H,)) as complex numpy arrays."""
    raw = read_ne_csv(path)
    want = [int(f) for f in settings.harmonics_freq]
    missing = [f for f in want if f not in raw["freqs"]]
    if missing:
        raise ValueError(
            f"{path} has no Norton data for frequencies {missing} "
            f"(available: {raw['freqs']})")
    cols = [raw["freqs"].index(f) for f in want]
    if coupled:
        rsel = [raw["y_row_freqs"].index(f) for f in want]
        Y = raw["Y_c"][np.ix_(rsel, cols)] / settings.base_admittance
        I = raw["I_c"][cols] / settings.base_current
    else:
        Y = raw["Y_uc"][cols] / settings.base_admittance
        I = raw["I_uc"][cols] / settings.base_current
    return I, Y


def resolve_ne_path(component: str, search_dirs: Sequence[str]) -> str:
    """Find ``<component>_NE.csv`` case-insensitively."""
    target = f"{component}_NE.csv".lower()
    for d in search_dirs:
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if fname.lower() == target:
                return os.path.join(d, fname)
    raise FileNotFoundError(
        f"no Norton-equivalent table {component}_NE.csv in {list(search_dirs)}")


def load_device_set(net: Network, settings: Settings,
                    search_dirs: Sequence[str] = (DATA_DIR,)) -> DeviceSet:
    """Load NEs for every nonlinear bus of ``net``, on ``net``'s device."""
    coupled = settings.coupled
    H = settings.n_harmonics
    rd = settings.real_dtype
    if net.n_nonlinear == 0:
        shape_y = (0, H, H) if coupled else (0, H)
        return DeviceSet(I_N=cx.zeros((0, H), rd, net.device),
                         Y_N=cx.zeros(shape_y, rd, net.device),
                         coupled=coupled)
    unique = {comp: load_norton_equivalent(resolve_ne_path(comp, search_dirs),
                                           settings, coupled)
              for comp in set(net.nonlinear_components)}
    I_N = np.stack([unique[c][0] for c in net.nonlinear_components])
    Y_N = np.stack([unique[c][1] for c in net.nonlinear_components])
    return DeviceSet(I_N=cx.from_numpy(I_N, rd, net.device),
                     Y_N=cx.from_numpy(Y_N, rd, net.device),
                     coupled=coupled)
