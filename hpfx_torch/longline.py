"""Distributed-parameter (long-line) branch model per harmonic order (the
port of :mod:`hpfx.longline`).

A nominal pi is a short-line approximation, and electrical length grows
with the harmonic order.  The exact equivalent pi of a uniform line is

    Z_pi   = Z · sinh(θ)/θ,            θ² = Z·Y,
    Y_pi/2 = (Y/2) · tanh(θ/2)/(θ/2),

elementwise over the (H, L) grid in split-complex form.  Both factors are
even in θ and are evaluated as functions of w = θ²; inside the cut-off
|w| < 1e-3 by their w-series, so lines with no charging reproduce the
nominal pi exactly.  The fundamental row is pinned to the nominal pi
unless ``include_fundamental``.  :func:`longline_structures` returns the
``(Y, lineY, lineY_f)`` triple of :func:`hpfx_torch.ybus.resolve_ybus`
and takes :mod:`hpfx_torch.lineskin`'s ``Rh``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network
from .ybus import build_ybus, fold_ydiag, line_ybus_pair

#: |θ²| below which the even θ²-series replaces the transcendental form
_SERIES_CUTOFF = 1e-3


def _guarded(theta2: Cx):
    """(small, w with 1 in place of the series' entries): the unused
    branch stays finite under ``where``."""
    small = theta2.abs2() < _SERIES_CUTOFF * _SERIES_CUTOFF
    return small, Cx(torch.where(small, 1.0, theta2.re),
                     torch.where(small, 0.0, theta2.im))


def _sinhc(theta2: Cx) -> Cx:
    """sinh(θ)/θ as a function of w = θ²: 1 + w/6 + w²/120 inside the
    cut-off, sinh(√w)/√w outside."""
    small, guard = _guarded(theta2)
    series = 1.0 + theta2 * (1.0 / 6.0) + (theta2 * theta2) * (1.0 / 120.0)
    th = cx.sqrt(guard)
    return cx.where(small, series, cx.sinh(th) / th)


def _tanhc_half(theta2: Cx) -> Cx:
    """tanh(θ/2)/(θ/2) as a function of w = θ²: 1 − w/12 + w²/120 inside
    the cut-off, sinh/(cosh·θ/2) outside."""
    small, guard = _guarded(theta2)
    series = (1.0 - theta2 * (1.0 / 12.0)
              + (theta2 * theta2) * (1.0 / 120.0))
    th_half = cx.sqrt(guard) * 0.5
    return cx.where(small, series,
                    cx.sinh(th_half) / (cx.cosh(th_half) * th_half))


def _branch_totals(net: Network, settings: Settings, Rh=None):
    """Total series impedance Z(h) and charging Y(h), both (H, L)."""
    rd = settings.real_dtype
    h = torch.tensor(settings.harmonics, dtype=rd,
                     device=net.device)[:, None]
    R = net.line_R if Rh is None else torch.as_tensor(Rh, dtype=rd,
                                                      device=net.device)
    shape = (settings.n_harmonics, net.n_lines)
    Z = Cx(R.expand(shape).to(rd), net.line_X * h)
    Y = Cx(net.line_G.expand(shape).to(rd), net.line_B * h)
    return Z, Y


def longline_factors(net: Network, settings: Settings, Rh=None, *,
                     include_fundamental: bool = False):
    """Per-line, per-harmonic correction factors ``(Ks, Kp)``, split-complex
    (H, L): ``Z_pi = Z·Ks`` and ``Y_pi/2 = (Y/2)·Kp``; the h = 1 row pinned
    to (1, 1) unless ``include_fundamental``."""
    Z, Y = _branch_totals(net, settings, Rh)
    theta2 = Z * Y
    Ks, Kp = _sinhc(theta2), _tanhc_half(theta2)
    if not include_fundamental:
        pin = lambda K: Cx(torch.cat([torch.ones_like(K.re[:1]), K.re[1:]]),
                           torch.cat([torch.zeros_like(K.im[:1]), K.im[1:]]))
        Ks, Kp = pin(Ks), pin(Kp)
    return Ks, Kp


def electrical_length(net: Network, settings: Settings, Rh=None):
    """|θ(h)| = |sqrt(Z·Y)| per harmonic and line, (H, L) real: |θ| > ~0.5
    rad flags the orders where the correction is material."""
    Z, Y = _branch_totals(net, settings, Rh)
    return torch.sqrt((Z * Y).abs2()) ** 0.5


def longline_structures(net: Network, settings: Settings, Rh=None, *,
                        include_fundamental: bool = False,
                        Y_diag: Optional[Cx] = None):
    """``(Y, lineY, lineY_f)`` with the exact-pi branches folded into both
    the dense tensor and the line structure; ``Rh`` composes skin effect
    underneath, ``Y_diag`` a load table on top."""
    Z, Yc = _branch_totals(net, settings, Rh)
    Ks, Kp = longline_factors(net, settings, Rh,
                              include_fundamental=include_fundamental)
    Ys = (Z * Ks).reciprocal()
    Ysh = (Yc * 0.5) * Kp
    Y = build_ybus(net, settings, Ys=Ys, Ysh=Ysh)
    lineY, lineY_f = line_ybus_pair(net, settings, Ys=Ys, Ysh=Ysh)
    if Y_diag is not None:
        Y = fold_ydiag(Y, Y_diag)
        if lineY is not None:
            lineY = lineY._replace(d=lineY.d + Y_diag)
            lineY_f = lineY_f._replace(d=lineY_f.d + Y_diag[:1])
    return Y, lineY, lineY_f
