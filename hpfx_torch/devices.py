"""Nonlinear device models: the PyTorch counterpart of :mod:`hpfx.devices`.

- the ``<device>_NE.csv`` reader, per-unit conversion and the
  case-insensitive file lookup;
- :class:`DeviceSet`, the Norton equivalents of every nonlinear bus
  stacked — ``I_N (n_nl, H)`` and ``Y_N (n_nl, H, H)`` coupled or
  ``(n_nl, H)`` uncoupled;
- :class:`DeviceLibrary`, a palette of device types that a sweep's
  ``Scenarios.device_mix`` blends per bus;
- :class:`AnalyticDeviceSet`, devices given by a differentiable injection
  function, whose Jacobian blocks come from ``torch.func.jacfwd``.

The NE tables are read in place from the JAX package's data directory, by
path.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from numbers import Number
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import cx
from ._device import resolve_device
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


@dataclasses.dataclass(frozen=True)
class DeviceLibrary:
    """A palette of T Norton-equivalent device types for device-mix sweeps
    (``hpfx.devices.DeviceLibrary``): ``I_lib (T, H)``, ``Y_lib (T, H, H)``
    coupled or ``(T, H)`` uncoupled.  :meth:`mixed` blends them into a
    per-bus DeviceSet, I_N[d] = sum_t w[d, t]·I_lib[t] (same for Y_N):
    Norton parameters enter linearly, so a weighted sum is the physics of
    w[d, t] parallel devices of type t at bus d."""

    I_lib: Cx
    Y_lib: Cx
    coupled: bool
    names: Tuple[str, ...] = ()

    @property
    def n_types(self) -> int:
        return self.I_lib.shape[0]

    def mixed(self, w) -> DeviceSet:
        """Blend with weights ``w (..., n_nl, T)``; leading axes are
        scenarios, which the DeviceSet then carries in front."""
        w = torch.as_tensor(w, dtype=self.I_lib.dtype,
                            device=self.I_lib.device)
        es = lambda spec, arr: Cx(torch.einsum(spec, w, arr.re),
                                  torch.einsum(spec, w, arr.im))
        return DeviceSet(
            I_N=es("...dt,th->...dh", self.I_lib),
            Y_N=es("...dt,thp->...dhp" if self.coupled else "...dt,th->...dh",
                   self.Y_lib),
            coupled=self.coupled)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def to(self, device=None, dtype=None) -> "DeviceLibrary":
        kw = dict(device=device, dtype=dtype)
        return dataclasses.replace(self, I_lib=self.I_lib.to(**kw),
                                   Y_lib=self.Y_lib.to(**kw))


def load_device_library(components: Sequence[str], settings: Settings,
                        search_dirs: Sequence[str] = (DATA_DIR,),
                        device=None) -> DeviceLibrary:
    """The NE tables of ``components`` (device-type names) stacked into a
    :class:`DeviceLibrary` on ``device`` (default: the CUDA card,
    :func:`hpfx_torch._device.resolve_device`), with the per-unit
    conversion and file lookup of :func:`load_device_set`."""
    device = resolve_device(device)
    pairs = [load_norton_equivalent(resolve_ne_path(comp, search_dirs),
                                    settings, settings.coupled)
             for comp in components]
    rd = settings.real_dtype
    return DeviceLibrary(
        I_lib=cx.from_numpy(np.stack([p[0] for p in pairs]), rd, device),
        Y_lib=cx.from_numpy(np.stack([p[1] for p in pairs]), rd, device),
        coupled=settings.coupled, names=tuple(components))


def device_set_from_arrays(I_N, Y_N, coupled: bool, settings: Settings,
                           device=None) -> DeviceSet:
    """A DeviceSet from complex numpy arrays or ``Cx`` pairs; a single
    device's (H,) / (H, H) arrays gain the device axis.  Numpy input goes
    to ``device`` (default: the CUDA card); ``Cx`` input stays where it
    is, cast to ``settings.real_dtype``."""
    rd = settings.real_dtype

    def conv(a):
        if isinstance(a, Cx):
            return a.to(dtype=rd)
        return cx.from_numpy(a, rd, resolve_device(device))

    I_N, Y_N = conv(I_N), conv(Y_N)
    if Y_N.ndim == (2 if coupled else 1):
        I_N, Y_N = I_N[None], Y_N[None]
    return DeviceSet(I_N=I_N, Y_N=Y_N, coupled=coupled)


def _map_floats(tree, fn):
    """Apply ``fn`` to every floating tensor of a nested tuple/list/Cx."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, Cx):
        return Cx(fn(tree.re), fn(tree.im))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_floats(t, fn) for t in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class AnalyticDeviceSet:
    """Nonlinear devices given by a differentiable injection
    (``hpfx.devices.AnalyticDeviceSet``).

    ``inject(params_i, V_m (H,), V_a (H,)) -> Cx (H,)`` maps one device's
    bus-voltage spectrum (signed magnitudes and angles, the solver's own
    state) to its injected current.  ``params`` is a nested tuple of
    tensors or ``Cx`` pairs whose leaves carry a leading n_nl axis.  The
    Jacobian coupling blocks come from ``torch.func.jacfwd`` of ``inject``,
    vectorized by ``torch.func.vmap`` over the devices (and over any
    leading scenario axes).  ``inj_scale``: a scalar, (n_nl,), or with
    leading scenario axes (..., n_nl) or (..., 1); every device's current,
    and so its Jacobian coupling, is scaled by it, as DeviceSet.scale
    scales I_N and Y_N."""

    params: object
    inject: object
    n_nl: int
    inj_scale: object = 1.0

    coupled = True  # treated as fully harmonic-coupled by the solver

    @property
    def n_devices(self) -> int:
        return self.n_nl

    def scale(self, factor) -> "AnalyticDeviceSet":
        return dataclasses.replace(self, inj_scale=self.inj_scale * factor)

    def to(self, device=None, dtype=None) -> "AnalyticDeviceSet":
        mv = lambda t: t.to(device=device, dtype=dtype)
        s = self.inj_scale
        return dataclasses.replace(
            self, params=_map_floats(self.params, mv),
            inj_scale=s if isinstance(s, Number) else mv(s))

    def _s(self, extra_dims: int):
        """inj_scale broadcast against a (..., n_nl, ...) array."""
        s = self.inj_scale
        if isinstance(s, Number) or s.dim() == 0:
            return s
        return s.reshape(s.shape + (1,) * extra_dims)

    def _vmapped(self, fn, lead: int):
        """``fn(params_i, vm, va)`` over the devices (the last axis of the
        voltages) and ``lead`` leading scenario axes."""
        f = torch.func.vmap(fn, in_dims=(0, -1, -1))
        for _ in range(lead):
            f = torch.func.vmap(f, in_dims=(None, 0, 0))
        return f

    def injections(self, V_m_nl, V_a_nl) -> Cx:
        """All devices' injections: V_*_nl (..., H, n_nl) -> (..., n_nl, H)."""
        f = self._vmapped(self.inject, V_m_nl.dim() - 2)
        return f(self.params, V_m_nl, V_a_nl) * self._s(1)

    def injection_jacobians(self, V_m_nl, V_a_nl):
        """dI_inj/d(V_m, V_a) per device: two Cx (..., n_nl, H, H),
        [..., d, h, p] = dI_inj[d, h] / dV_{m|a}[p, d]."""
        def per_bus(p, vm, va):
            JV = torch.func.jacfwd(lambda v: self.inject(p, v, va))(vm)
            JA = torch.func.jacfwd(lambda a: self.inject(p, vm, a))(va)
            return JV, JA

        JV, JA = self._vmapped(per_bus, V_m_nl.dim() - 2)(
            self.params, V_m_nl, V_a_nl)
        return JV * self._s(2), JA * self._s(2)


def norton_inject(params, V_m, V_a) -> Cx:
    """Norton-equivalent injection as an analytic device: params = (I_N,
    Y_N) with Y_N (H, H); I = I_N − Y_N·V."""
    I_N, Y_N = params
    return I_N - cx.matvec(Y_N, cx.polar(V_m, V_a))


# ---------------------------------------------------------------------------
# Norton-equivalent fitting (differentiable; hpfx.devices:324-386)
# ---------------------------------------------------------------------------

def _as_cx(x, device=None) -> Cx:
    """``x`` as a Cx: a Cx stays as it is; a numpy (complex) array goes to
    ``device`` (default: the CUDA card) in its own precision, float64
    unless it is complex64/float32."""
    if isinstance(x, Cx):
        return x
    arr = np.asarray(x)
    dt = (torch.float32 if arr.dtype in (np.complex64, np.float32)
          else torch.float64)
    return cx.from_numpy(arr, dt, resolve_device(device))


def fit_coupled_ne(V_mes, I_mes, device=None):
    """Coupled HCNE fit (Almeida 2010; ``hpfx.devices.fit_coupled_ne``).

    Given M = H+1 measurements of applied voltage spectra ``V_mes (M, H)``
    and injected current spectra ``I_mes (M, H)``, solve for each output
    harmonic j the linear system I[k,j] = I_N[j] − Σ_p Y_N[j,p] V[k,p],
    i.e. [−V | 1] @ [Y_N[j,:] ; I_N[j]] = I[:,j], with one
    ``torch.linalg.solve`` (:func:`hpfx_torch.cx.solve`, as the JAX
    package takes ``jnp.linalg.solve``).  Accepts complex numpy arrays
    (put on ``device``) or ``Cx``; returns (I_N (H,), Y_N (H,H)) as Cx.
    """
    V_mes, I_mes = _as_cx(V_mes, device), _as_cx(I_mes, device)
    M, H = V_mes.shape
    if M != H + 1:
        raise ValueError(f"coupled fit needs H+1={H + 1} measurements, got {M}")
    kw = dict(dtype=V_mes.dtype, device=V_mes.device)
    ones = Cx(torch.ones((M, 1), **kw), torch.zeros((M, 1), **kw))
    A = cx.concatenate([-V_mes, ones], axis=1)
    X = cx.solve(A, I_mes)               # (H+1, H): rows = [Y_N^T ; I_N]
    Y_N = X[:-1].T
    I_N = X[-1]
    return I_N, Y_N


def fit_uncoupled_ne(V_m1, I_m1, V_m2, I_m2, device=None):
    """Uncoupled NE fit (Thunberg 1999; ``hpfx.devices.fit_uncoupled_ne``).

    Per harmonic h, from two measurements (V1[h], I1[h]) and (V2[h], I2[h]):
        Y_N[h] = (I2[h] − I1[h]) / (V1[h] − V2[h])
        I_N[h] = Y_N[h]·V1[h] + I1[h]
    All arguments shape (H,).  Returns (I_N (H,), Y_N (H,)) as Cx.
    """
    V_m1, I_m1 = _as_cx(V_m1, device), _as_cx(I_m1, device)
    V_m2, I_m2 = _as_cx(V_m2, device), _as_cx(I_m2, device)
    Y_N = (I_m2 - I_m1) / (V_m1 - V_m2)
    I_N = Y_N * V_m1 + I_m1
    return I_N, Y_N


def ne_injection(I_N, Y_N, V, device=None) -> Cx:
    """Model current injection I = I_N − Y_N·V (coupled or uncoupled),
    the sign convention of hcne_generalized.py:320-322."""
    I_N, Y_N, V = (_as_cx(a, device) for a in (I_N, Y_N, V))
    if Y_N.ndim == 2:
        return I_N - cx.matvec(Y_N, V)
    return I_N - Y_N * V


def ne_selftest(I_N, Y_N, V_mes, I_mes, device=None) -> torch.Tensor:
    """Max |model − measurement| over a measurement set; the reference
    warns above 1e-6 (NE_from_sim.py:132-135, 190-193)."""
    I_N, Y_N = _as_cx(I_N, device), _as_cx(Y_N, device)
    V, I = _as_cx(V_mes, device), _as_cx(I_mes, device)
    if V.ndim == 1:
        V, I = V[None], I[None]
    if Y_N.ndim == 2:
        pred = I_N[None, :] - cx.einsum("hp,mp->mh", Y_N, V)
    else:
        pred = I_N[None, :] - Y_N[None, :] * V
    return (pred - I).abs().max()


def check_devices(devices, library: bool = False) -> None:
    """Raise ``TypeError`` unless ``devices`` is a DeviceSet, an
    AnalyticDeviceSet or, where ``library``, a DeviceLibrary."""
    kinds = (DeviceSet, AnalyticDeviceSet) + ((DeviceLibrary,)
                                              if library else ())
    if not isinstance(devices, kinds):
        raise TypeError(
            f"devices must be one of {', '.join(k.__name__ for k in kinds)}"
            f", got {type(devices).__name__}"
            + ("" if library else
               " (a DeviceLibrary takes a sweep with Scenarios.device_mix)"))
