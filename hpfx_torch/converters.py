"""Analytic converter spectra: textbook harmonic current sources (the port
of :mod:`hpfx.converters`).

Uncoupled :class:`hpfx_torch.devices.DeviceSet` rows from closed-form
line-commutated converter spectra (:func:`six_pulse_spectrum`,
:func:`twelve_pulse_spectrum`) and percent-of-fundamental tables
(:func:`table_spectrum`), so analytic converters ride every solver and
study.  The spectra are built on the host in float64 numpy exactly as
the JAX package builds them, then made tensors.

Conventions: a positive-real fundamental is a load drawing that current;
``alpha``/``mu`` delay every order by e^{-j·h·(alpha + mu/2)}.  The
``leak`` floor of :func:`converter_device_set` keeps every order's
magnitude at least ``leak·|I_1|``: an order with no source anywhere has
the polar-singular solution V_h = 0.  :func:`converter_warm_start` is the
exact linear harmonic seed of such stiff sources; :func:`notch_analysis`
screens commutation notches against IEEE 519; :func:`synth_waveform`
rebuilds a period of the waveform.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from .config import Settings
from .devices import DeviceSet, device_set_from_arrays
from .network import Network

__all__ = ["six_pulse_spectrum", "twelve_pulse_spectrum", "table_spectrum",
           "converter_device_set", "converter_warm_start",
           "synth_waveform", "NotchReport", "notch_analysis",
           "NOTCH_LIMITS"]


def _sinc(x):
    """sin(x)/x with the removable singularity filled."""
    x = np.asarray(x, float)
    return np.where(np.abs(x) < 1e-12, 1.0, np.sin(np.where(x == 0, 1, x))
                    / np.where(x == 0, 1, x))


def six_pulse_spectrum(harmonics, I1: float = 1.0, alpha: float = 0.0,
                       mu: float = 0.0) -> np.ndarray:
    """Complex (H,) current phasors of an ideal 6-pulse converter drawing
    fundamental magnitude ``I1`` (pu), firing delay ``alpha`` [rad],
    commutation overlap ``mu`` [rad].

    In the cosine/phasor frame the characteristic coefficients are
    I_h/I_1 = +1/h at h = 6k+1 and −1/h at h = 6k−1 (the sine-series
    alternation −5, −7, +11, +13 re-expressed; validated against FFT of
    the synthesized waveform), times the overlap attenuation
    sinc(hμ/2)/sinc(μ/2) and the delay rotation e^{-jh(α+μ/2)}.
    """
    h = np.asarray(harmonics, float)
    mod6 = np.mod(np.rint(h), 6)
    char = (mod6 == 1) | (mod6 == 5)
    sign = np.where(mod6 == 1, 1.0, -1.0)
    mag = np.where(char, sign / np.where(char, h, 1.0), 0.0)
    mag = mag * _sinc(h * mu / 2.0) / _sinc(mu / 2.0)
    delta = alpha + mu / 2.0
    return I1 * mag * np.exp(-1j * h * delta)


def twelve_pulse_spectrum(harmonics, I1: float = 1.0, alpha: float = 0.0,
                          mu: float = 0.0) -> np.ndarray:
    """Complex (H,) phasors of the 12-pulse pair (Y-Y + Y-Δ bridge),
    total fundamental ``I1``: the 6-pulse spectrum times the exact
    cancellation multiplier (1 + (2/√3)·cos(hπ/6))/2 — 1 at h = 12k±1,
    0 at h = 6(2k+1)±1."""
    h = np.asarray(harmonics, float)
    mult = 0.5 * (1.0 + (2.0 / np.sqrt(3.0)) * np.cos(h * np.pi / 6.0))
    return six_pulse_spectrum(harmonics, I1, alpha, mu) * mult


def table_spectrum(harmonics, table: Mapping[int, tuple],
                   I1: float = 1.0, percent: bool = True) -> np.ndarray:
    """Complex (H,) phasors from a {order: (magnitude, angle_deg)} table
    — the IEEE-519 application-guide "typical spectrum" input format.
    ``percent=True`` reads magnitudes as % of fundamental (the table's
    h=1 row, if present, must then be 100).  Orders absent from the
    table inject zero; orders in the table but not solved are ignored.
    """
    h = np.asarray(harmonics, int)
    out = np.zeros(len(h), complex)
    scale = I1 / 100.0 if percent else 1.0
    for order, (mag, ang_deg) in table.items():
        idx = np.nonzero(h == int(order))[0]
        if idx.size:
            out[idx[0]] = scale * float(mag) * np.exp(
                1j * np.deg2rad(float(ang_deg)))
    if percent and 1 in {int(o) for o in table}:
        m1 = float(table[1][0]) if 1 in table else float(table[1.0][0])
        if abs(m1 - 100.0) > 1e-9:
            raise ValueError("percent tables must carry the fundamental "
                             f"as 100 (got {m1})")
    elif percent:
        out[0] = I1          # fundamental implied at 0°
    return out


Entry = Union[np.ndarray, Mapping]


def converter_device_set(net: Network, settings: Settings,
                         entries: Sequence[Entry], *,
                         leak: float = 1e-4) -> DeviceSet:
    """Uncoupled :class:`DeviceSet` from one spectrum per nonlinear bus.

    Each entry is either a complex (H,) phasor array (any generator
    above, or your own), or a mapping with a ``kind`` key:
    ``{"kind": "six_pulse"|"twelve_pulse", "I1": ..., "alpha": ...,
    "mu": ...}`` or ``{"kind": "table", "table": {...}, "I1": ...,
    "percent": ...}``.  ``leak`` floors every order's magnitude at
    ``leak·|I_1|`` (see the module docstring — zero-source orders are
    polar-singular).  Y_N is zero: these are stiff current sources; add
    damping via :mod:`hpfx_torch.loadmodel` or a shunt if the study needs it.
    """
    H = len(settings.harmonics)
    if len(entries) != net.n_nonlinear:
        raise ValueError(f"need one entry per nonlinear bus "
                         f"({net.n_nonlinear}), got {len(entries)}")
    rows = []
    for e in entries:
        if isinstance(e, Mapping):
            kind = e.get("kind", "six_pulse")
            kw = {k: v for k, v in e.items() if k != "kind"}
            if kind == "six_pulse":
                spec = six_pulse_spectrum(settings.harmonics, **kw)
            elif kind == "twelve_pulse":
                spec = twelve_pulse_spectrum(settings.harmonics, **kw)
            elif kind == "table":
                spec = table_spectrum(settings.harmonics, **kw)
            else:
                raise ValueError(f"unknown converter kind {kind!r}")
        else:
            spec = np.asarray(e, complex)
            if spec.shape != (H,):
                raise ValueError(f"spectrum entry must be ({H},), got "
                                 f"{spec.shape}")
        if leak:
            floor = leak * abs(spec[0])
            small = np.abs(spec) < floor
            spec = np.where(small, floor, spec)
        rows.append(spec)
    I_N = np.stack(rows)                                  # (n_nl, H)
    Y_N = np.zeros_like(I_N)
    return device_set_from_arrays(I_N, Y_N, coupled=False,
                                  settings=settings, device=net.device)


def converter_warm_start(net: Network, settings: Settings,
                         devices: DeviceSet, Y=None):
    """Exact linear harmonic seed ``(V_m, V_a)`` (H, n) for stiff
    current-source devices, the ``V0`` of ``hpf``: with Y_N = 0 the
    harmonic balance is linear, so V_h = −Y_h⁻¹·I_inj,h (one
    ``torch.linalg.solve`` of the real-embedded systems); the fundamental
    row starts flat 1∠0, and sourceless orders are lifted off the polar
    singularity.  ``Y`` as in ``hpf``."""
    from . import cx as _cx
    from .warmstart import _floor_seed_mag
    from .ybus import resolve_ybus
    if devices.coupled:
        raise ValueError("converter_warm_start expects an uncoupled "
                         "current-source DeviceSet")
    Yd, _, _ = resolve_ybus(net, settings, Y)
    m = net.m
    H, n = len(settings.harmonics), net.n
    rd, dv = settings.real_dtype, net.device
    I_full = _cx.zeros((H, n), rd, dv)
    I_full = I_full.at_set((slice(None), slice(m, None)), devices.I_N.T)
    V_h = _cx.solve(Yd[1:], -I_full[1:])                  # (H-1, n)
    V_m = torch.cat([torch.ones((1, n), dtype=rd, device=dv),
                     _floor_seed_mag(V_h.abs(), settings)])
    V_a = torch.cat([torch.zeros((1, n), dtype=rd, device=dv),
                     V_h.angle()])
    return V_m, V_a


#: IEEE Std 519 notching limits by application class at the PCC:
#: (max depth %, max notch area V·µs referenced to a 480 V system —
#: scale by V/480 above 480 V).  Verify against your standard edition.
NOTCH_LIMITS = {
    "special": (10.0, 16400.0),
    "general": (20.0, 22800.0),
    "dedicated": (50.0, 36500.0),
}


class NotchReport(NamedTuple):
    """Commutation-notch quantities at the observation bus.

    ``depth_pct``: notch depth as % of the instantaneous line-line
    voltage (100 at the converter bus; elsewhere scaled by the
    reactance divider).  ``width_us``: notch width = commutation angle
    μ in time units.  ``area_vus``: notch area in volt-microseconds on
    the physical voltage base.  ``limit_*``/``compliant``: the selected
    IEEE-519 application-class check."""
    depth_pct: float
    width_us: float
    area_vus: float
    divider: float
    limit_depth_pct: float
    limit_area_vus: float
    compliant: bool


def notch_analysis(net: Network, settings: Settings, converter_bus: int,
                   *, alpha: float, mu: float,
                   observe_bus: int = None,
                   v_class: str = "general") -> NotchReport:
    """Line-commutation voltage-notch screening (IEEE 519's notching
    limits — the one distortion mechanism a harmonic-domain solve
    cannot see, because a notch is a sub-cycle transient whose spectrum
    spreads far above the solved orders).

    Physics: during commutation the bridge momentarily shorts two
    phases through the path reactance, collapsing the line-line voltage
    at the converter bus; at any other bus the notch appears scaled by
    the fundamental-frequency reactance divider, computed here from the
    passive nodal impedance matrix as
    ``|Z_transfer(obs, conv)| / |Z_driving(conv)|`` (exactly the
    upstream-fraction X_s/(X_s + X_t) on a radial feeder, and the
    correct generalization on meshed ones).  Notch voltage uses the
    standard approximation ``V_N = √2·V_LL·sin(α + μ/2)·divider`` and
    width ``t_N = μ/ω``; ``settings.base_voltage`` is taken as the
    line-line system voltage.
    """
    if v_class not in NOTCH_LIMITS:
        raise ValueError(f"unknown v_class {v_class!r}: use one of "
                         f"{tuple(NOTCH_LIMITS)}")
    if observe_bus is None:
        observe_bus = converter_bus
    from .impedance import impedance_scan
    Z = impedance_scan(net, settings)                  # passive, grounded
    zc = complex(float(Z.re[0, converter_bus, converter_bus]),
                 float(Z.im[0, converter_bus, converter_bus]))
    zt = complex(float(Z.re[0, observe_bus, converter_bus]),
                 float(Z.im[0, observe_bus, converter_bus]))
    div = abs(zt) / max(abs(zc), 1e-30)
    depth = 100.0 * div
    w = 2.0 * np.pi * settings.net_freq
    width_us = float(mu) / w * 1e6
    v_ll = settings.base_voltage
    v_notch = np.sqrt(2.0) * v_ll * abs(np.sin(alpha + mu / 2.0)) * div
    area = v_notch * width_us
    lim_d, lim_a480 = NOTCH_LIMITS[v_class]
    lim_a = lim_a480 * max(v_ll / 480.0, 1.0)
    return NotchReport(depth_pct=depth, width_us=width_us,
                       area_vus=float(area), divider=div,
                       limit_depth_pct=lim_d, limit_area_vus=lim_a,
                       compliant=bool(depth <= lim_d and area <= lim_a))


def synth_waveform(spectrum, harmonics, n: int = 4096):
    """(theta, i(theta)) one-period time reconstruction of a phasor
    spectrum — Re Σ_h I_h·e^{jhθ} on an ``n``-point grid.  For plots and
    the FFT cross-validation of the closed forms."""
    theta = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    h = np.asarray(harmonics, float)
    wave = np.real(np.asarray(spectrum, complex)[None, :]
                   * np.exp(1j * theta[:, None] * h[None, :])).sum(axis=1)
    return theta, wave
