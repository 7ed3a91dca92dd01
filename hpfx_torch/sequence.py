"""Sequence-domain analysis of balanced-system harmonic spectra (the port
of :mod:`hpfx.sequence`).

Under balanced conditions each harmonic order maps to one symmetrical-
component sequence: h mod 3 == 1 positive, == 2 negative, == 0 zero (the
triplens).  Post-processing of solved spectra: the neutral current of a
4-wire system (:func:`neutral_current`), delta-winding blocking
(:func:`delta_blocked`), the Fortescue transform and its inverse
(:func:`sequence_components`, :func:`phase_components`) and the three
phase spectra of a balanced solution (:func:`balanced_phases`).

Sequence-aware networks: each order propagates through the network of
its own sequence, so the triplen rows of the admittance come from the
zero-sequence companion network (:func:`zero_sequence_network`, with
blocked lines and grounded neutrals), assembled as a dense ``Y`` with the
matching line structure (:func:`sequence_structures`); :func:`hpf_sequence`
solves with it, and :func:`delta_device_set` masks delta-connected
converters' zero-sequence rows and columns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cx
from .cx import Cx

POSITIVE, NEGATIVE, ZERO = 1, 2, 0


def classify_orders(harmonics: Sequence[int]) -> np.ndarray:
    """Per-order sequence class under balanced conditions: ``h % 3``
    (``POSITIVE`` 1, ``NEGATIVE`` 2, ``ZERO`` 0, the triplens)."""
    return np.asarray([int(h) % 3 for h in harmonics], np.int32)


def triplen_mask(harmonics: Sequence[int]) -> np.ndarray:
    """(H,) bool: True on the zero-sequence (triplen) orders."""
    return classify_orders(harmonics) == ZERO


def _along(mask: np.ndarray, like: torch.Tensor, axis: int) -> torch.Tensor:
    """The (H,) ``mask`` as ``like``'s dtype, shaped to broadcast along
    ``axis``."""
    shape = [1] * like.ndim
    shape[axis] = -1
    return torch.as_tensor(mask, dtype=like.dtype,
                           device=like.device).reshape(shape)


def neutral_current(I_m: torch.Tensor, harmonics: Sequence[int],
                    axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neutral harmonic currents of a balanced 4-wire system from per-phase
    magnitudes ``I_m`` (harmonic axis ``axis``): (3·I_h on the triplens, 0
    elsewhere; their RMS along the harmonic axis)."""
    i_n = 3.0 * I_m * _along(triplen_mask(harmonics), I_m, axis)
    return i_n, torch.sqrt(torch.sum(i_n * i_n, dim=axis))


def delta_blocked(spectrum: torch.Tensor, harmonics: Sequence[int],
                  axis: int = 0) -> torch.Tensor:
    """The spectrum through a delta winding: the triplens removed."""
    return spectrum * _along(~triplen_mask(harmonics), spectrum, axis)


class SequenceSet(NamedTuple):
    """Symmetrical components of a three-phase phasor set (split-complex,
    the inputs' shape)."""
    zero: Cx
    positive: Cx
    negative: Cx


def _alpha() -> Cx:
    """The Fortescue rotation a = e^{j 2pi/3}."""
    return Cx(-0.5, math.sqrt(3.0) / 2.0)


def sequence_components(va: Cx, vb: Cx, vc: Cx) -> SequenceSet:
    """Fortescue transform: V0 = (Va + Vb + Vc)/3, V1 = (Va + a·Vb +
    a²·Vc)/3, V2 = (Va + a²·Vb + a·Vc)/3, for any broadcastable shape."""
    a = _alpha()
    a2 = a * a
    third = 1.0 / 3.0
    return SequenceSet(
        zero=(va + vb + vc) * third,
        positive=(va + a * vb + a2 * vc) * third,
        negative=(va + a2 * vb + a * vc) * third)


def phase_components(seq: SequenceSet) -> Tuple[Cx, Cx, Cx]:
    """Inverse Fortescue: (Va, Vb, Vc) from a :class:`SequenceSet`."""
    a = _alpha()
    a2 = a * a
    v0, v1, v2 = seq.zero, seq.positive, seq.negative
    return (v0 + v1 + v2, v0 + a2 * v1 + a * v2, v0 + a * v1 + a2 * v2)


def balanced_phases(V_m: torch.Tensor, V_a: torch.Tensor,
                    harmonics: Sequence[int]) -> Tuple[Cx, Cx, Cx]:
    """The three phase spectra of a balanced (H, ...) solution: phase a as
    solved, phases b/c rotated by ∓ h·120° per order."""
    rot = (2.0 * math.pi / 3.0) * _along(np.asarray(harmonics, float), V_m, 0)
    return (cx.polar(V_m, V_a), cx.polar(V_m, V_a - rot),
            cx.polar(V_m, V_a + rot))


# ---------------------------------------------------------------------------
# sequence-aware harmonic networks
# ---------------------------------------------------------------------------

def _keep(n: int, dropped: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    """A 0/1 mask of length n, zero at ``dropped``, as ``like``'s tensor."""
    keep = np.ones(n)
    for k in dropped:
        keep[int(k)] = 0.0
    return torch.as_tensor(keep, dtype=like.dtype, device=like.device)


def zero_sequence_network(net, *, r0_scale: float = 2.5,
                          x0_scale: float = 3.0,
                          b0_scale: float = 1.0,
                          R0=None, X0=None,
                          ungrounded_shunts: Sequence[int] = ()):
    """The zero-sequence companion of ``net``: the same topology and taps,
    line impedances scaled by ``r0_scale``/``x0_scale`` (or given as
    ``R0``/``X0``), charging by ``b0_scale``, and no shunt at the
    ``ungrounded_shunts`` buses."""
    t = lambda a: torch.as_tensor(a, dtype=net.line_R.dtype,
                                  device=net.device)
    R0 = net.line_R * r0_scale if R0 is None else t(R0)
    X0 = net.line_X * x0_scale if X0 is None else t(X0)
    return dataclasses.replace(
        net, line_R=R0, line_X=X0, line_B=net.line_B * b0_scale,
        bus_Xsh=net.bus_Xsh * _keep(net.n, ungrounded_shunts, net.bus_Xsh))


def _grounding_diag(settings, bus_Xg: Optional[Mapping[int, float]],
                    n: int, device) -> Optional[Cx]:
    """(H, n) zero-sequence grounding shunts on ``device``: a grounded
    neutral of total zero-sequence reactance Xg admits −j/(h·Xg), on every
    order (the blend keeps it to the triplen rows)."""
    if not bus_Xg:
        return None
    h = np.asarray(settings.harmonics, float)[:, None]          # (H, 1)
    g = np.zeros((len(settings.harmonics), n))
    b = np.zeros_like(g)
    for bus, xg in bus_Xg.items():
        if xg <= 0.0:
            raise ValueError(f"bus_Xg[{bus}] must be a positive reactance")
        b[:, int(bus)] = (-1.0 / (h * xg))[:, 0]
    t = lambda a: torch.as_tensor(a, dtype=settings.real_dtype,
                                  device=device)
    return Cx(t(g), t(b))


def _dense_from_line(lineY, n: int) -> Cx:
    """The dense (H, n, n) admittance of a ``LineYbus``, the scatter of
    ``build_ybus`` from its un-summed pieces, so both forms describe the
    same system."""
    Ys, f, t = lineY.Ys, lineY.f_idx, lineY.t_idx
    inv_t_ft = cx.expj(lineY.shift) * lineY.inv_tau
    inv_t_tf = cx.expj(-lineY.shift) * lineY.inv_tau
    _all = slice(None)
    Y = cx.zeros((Ys.shape[0], n, n), Ys.dtype, Ys.device)
    Y = Y.at_add((_all, f, t), -(Ys * inv_t_ft))
    Y = Y.at_add((_all, t, f), -(Ys * inv_t_tf))
    Y = Y.at_add((_all, f, f), Ys * lineY.a_ff)
    Y = Y.at_add((_all, t, t), Ys)
    idx = torch.arange(n, device=Ys.device)
    return Y.at_add((_all, idx, idx), lineY.d)


def _zero_companion(net, settings, net0, blocked, zero_kw):
    """The zero-sequence network (given or built), its ``blocked`` lines'
    pi shunts zeroed, and the blocked mask."""
    if net0 is None:
        net0 = zero_sequence_network(net, **zero_kw)
    elif zero_kw:
        raise ValueError("pass either net0 or zero-sequence parameters")
    if tuple(net0.line_tau.shape) != tuple(net.line_tau.shape):
        raise ValueError("net0 must share net's line topology")
    keep = _keep(net.n_lines, blocked, net.line_R).to(settings.real_dtype)
    net0 = dataclasses.replace(net0, line_G=net0.line_G * keep,
                               line_B=net0.line_B * keep)
    return net0, keep


def sequence_structures(net, settings, net0=None, *,
                        blocked: Sequence[int] = (),
                        bus_Xg: Optional[Mapping[int, float]] = None,
                        Y_diag: Optional[Cx] = None, **zero_kw):
    """Per-order blended ``(Y, lineY, lineY_f)``: the triplen rows from the
    zero-sequence network (``net0``, or :func:`zero_sequence_network` of
    ``zero_kw``), the others from ``net``.  ``blocked`` lines lose their
    series element and pi shunt in the triplen rows; ``bus_Xg`` adds
    grounded-neutral shunts; ``lineY``/``lineY_f`` are None when
    ``settings.stable_mismatch`` is off."""
    from .ybus import LineYbus, build_line_ybus
    net0, keep = _zero_companion(net, settings, net0, blocked, zero_kw)
    lineY1 = build_line_ybus(net, settings)
    lineY0 = build_line_ybus(net0, settings)
    Ys0 = lineY0.Ys * keep
    d0 = lineY0.d
    g = _grounding_diag(settings, bus_Xg, net.n, net.device)
    if g is not None:
        d0 = d0 + g

    tri = torch.as_tensor(triplen_mask(settings.harmonics),
                          device=net.device)[:, None]
    d = cx.where(tri, d0, lineY1.d)
    if Y_diag is not None:
        d = d + Y_diag
    blended = LineYbus(Ys=cx.where(tri, Ys0, lineY1.Ys), a_ff=lineY1.a_ff,
                       inv_tau=lineY1.inv_tau, shift=lineY1.shift, d=d,
                       f_idx=lineY1.f_idx, t_idx=lineY1.t_idx)
    Y = _dense_from_line(blended, net.n)
    if not settings.stable_mismatch:
        return Y, None, None
    return Y, blended, blended._replace(Ys=blended.Ys[:1], d=blended.d[:1])


def delta_device_set(devices, settings, delta: Sequence[int]):
    """Norton equivalents of delta-connected converters: the ``delta``
    devices (0 = first nonlinear bus) lose their triplen I_N rows and,
    coupled, the triplen rows and columns of Y_N."""
    rd = settings.real_dtype
    dm = _keep(devices.n_devices, delta, devices.I_N.re).to(rd)
    dm = 1.0 - dm                                                # delta: 1
    tri = torch.as_tensor(triplen_mask(settings.harmonics), dtype=rd,
                          device=dm.device)
    keep_i = 1.0 - dm[:, None] * tri[None, :]                    # (n_nl, H)
    I_N = devices.I_N * keep_i
    if devices.coupled:
        blk = torch.maximum(tri[:, None], tri[None, :])          # row OR col
        Y_N = devices.Y_N * (1.0 - dm[:, None, None] * blk[None, :, :])
    else:
        Y_N = devices.Y_N * keep_i
    return dataclasses.replace(devices, I_N=I_N, Y_N=Y_N)


def hpf_sequence(net, devices, settings, *, net0=None,
                 blocked: Sequence[int] = (),
                 bus_Xg: Optional[Mapping[int, float]] = None,
                 delta_devices: Sequence[int] = (),
                 V0=None, I_bg: Optional[Cx] = None,
                 Y_diag: Optional[Cx] = None,
                 record_trajectory: bool = False, **zero_kw):
    """Sequence-aware harmonic power flow: :func:`hpfx_torch.harmonic.hpf`
    with the triplen orders on the zero-sequence network
    (:func:`sequence_structures`), ``delta_devices`` masked by
    :func:`delta_device_set`; the same as ``hpf`` when the sequence
    networks coincide."""
    from .harmonic import hpf
    structs = sequence_structures(
        net, settings, net0, blocked=blocked, bus_Xg=bus_Xg, Y_diag=Y_diag,
        **zero_kw)
    if delta_devices:
        devices = delta_device_set(devices, settings, delta_devices)
    return hpf(net, devices, settings, Y=structs, V0=V0,
               record_trajectory=record_trajectory, I_bg=I_bg)
