"""Per-harmonic network impedance analysis (the port of
:mod:`hpfx.impedance`): the nodal impedance matrices ``Z(h) = Y(h)^-1``
of every harmonic order from the same Ybus assembly the solver uses,
parallel-resonance peaks, shunt filter admittances (single-tuned,
high-pass, C-type) and their installation, off-grid frequency scans and
per-device distortion contributions.

Split-complex throughout; the per-harmonic inversion is one H-batched
complex solve (:func:`hpfx_torch.cx.solve`).  The Ybus updates are
written out of place (a one-hot diagonal added), so that the filter
sensitivities can differentiate through them with ``torch.func``.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import cx
from ._device import resolve_device
from .config import Settings
from .cx import Cx
from .network import Network
from .ybus import build_ybus

__all__ = ["impedance_scan", "driving_point_impedance", "resonance_peaks",
           "tuned_filter_admittance", "highpass_filter_admittance",
           "ctype_filter_admittance", "install_shunt", "install_shunts",
           "frequency_scan", "grid_ybus", "distortion_contributions"]


def _norton_diag(devices) -> Cx:
    """Per-device Norton admittance h-diagonal, (n_nl, H); the diagonal of
    a coupled device's (H, H) matrix."""
    yn = devices.Y_N
    if getattr(devices, "coupled", False):
        yn = Cx(torch.diagonal(yn.re, dim1=-2, dim2=-1),
                torch.diagonal(yn.im, dim1=-2, dim2=-1))
    return yn


def _add_diag(Y: Cx, d: Cx) -> Cx:
    """(K, n, n) ``Y`` with the (K, n) ``d`` added on its diagonal."""
    return Cx(Y.re + torch.diag_embed(d.re), Y.im + torch.diag_embed(d.im))


def _fold_norton(Y: Cx, net: Network, yn: Cx) -> Cx:
    """Subtract per-device Norton diagonals ``yn`` (n_nl, K) from the
    nonlinear buses' (m..n-1) diagonal of the (K, n, n) admittances."""
    pad = lambda z: torch.cat([torch.zeros(z.shape[1], net.m, dtype=z.dtype,
                                           device=z.device), -z.T], dim=1)
    return _add_diag(Y, Cx(pad(yn.re), pad(yn.im)))


def _eye(H: int, n: int, rd, device) -> Cx:
    eye = torch.eye(n, dtype=rd, device=device).expand(H, n, n)
    return Cx(eye, torch.zeros_like(eye))


def impedance_scan(net: Network, settings: Settings,
                   Y: Optional[Cx] = None, devices=None,
                   ground_slack: bool = True) -> Cx:
    """Nodal impedance matrices ``Z(h)``, (H, n, n)
    (``hpfx.impedance.impedance_scan``).

    ``devices``: Norton admittances (the h-diagonal of coupled ones)
    subtracted at the nonlinear buses, the operational scan.
    ``ground_slack``: the slack is an ideal source, its row and column
    removed before the inversion and put back as zeros.  ``Y``: optional
    admittance override."""
    if Y is None:
        Y = build_ybus(net, settings)
    if devices is not None and devices.n_devices:
        Y = _fold_norton(Y, net, _norton_diag(devices))
    H, n = Y.shape[0], Y.shape[1]
    rd, dv = settings.real_dtype, Y.device
    if ground_slack:
        Zr = cx.solve(Y[:, 1:, 1:], _eye(H, n - 1, rd, dv))
        pad = lambda z: torch.nn.functional.pad(z, (1, 0, 1, 0))
        return Cx(pad(Zr.re), pad(Zr.im))
    return cx.solve(Y, _eye(H, n, rd, dv))


def _diag_abs(Z: Cx) -> torch.Tensor:
    re = torch.diagonal(Z.re, dim1=-2, dim2=-1)
    im = torch.diagonal(Z.im, dim1=-2, dim2=-1)
    return torch.sqrt(re * re + im * im)


def driving_point_impedance(net: Network, settings: Settings,
                            Y: Optional[Cx] = None, devices=None,
                            ground_slack: bool = True) -> torch.Tensor:
    """Driving-point impedance magnitudes ``|Z_kk(h)|``, (H, n)."""
    return _diag_abs(impedance_scan(net, settings, Y=Y, devices=devices,
                                    ground_slack=ground_slack))


def resonance_peaks(zmag: torch.Tensor, settings: Settings
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel-resonance candidates of an (H, n) driving-point scan:
    ``(is_peak (H, n), worst_h (n,), worst_z (n,))``, the strict local
    maxima over harmonic order (endpoints count against their one
    neighbour), and each bus's largest magnitude and its order."""
    ones = torch.ones_like(zmag[:1], dtype=torch.bool)
    up = torch.cat([ones, zmag[1:] > zmag[:-1]], dim=0)
    down = torch.cat([zmag[:-1] > zmag[1:], ones], dim=0)
    is_peak = up & down & (zmag > 0)
    hs = torch.tensor(settings.harmonics, device=zmag.device)
    k = zmag.argmax(dim=0)
    return is_peak, hs[k], torch.take_along_dim(zmag, k[None], dim=0)[0]


def _filter_inputs(settings: Settings, device, *params):
    """The harmonic orders and the parameters as tensors in the settings'
    dtype: on the parameters' device when one is a tensor, else on
    ``device`` (default: the CUDA card).  Plain numbers (the quality
    factor too) become tensors: torch.func's forward mode gives a 0-d
    float32 parameter divided by a Python float a float64 tangent, which
    a float32 solve then refuses."""
    rd = settings.real_dtype
    dv = next((p.device for p in params if isinstance(p, torch.Tensor)),
              None)
    dv = resolve_device(device) if dv is None else dv
    t = lambda p: (p.to(rd) if isinstance(p, torch.Tensor)
                   else torch.tensor(p, dtype=rd, device=dv))
    h = torch.tensor(settings.harmonics, dtype=rd, device=dv)
    return (h,) + tuple(t(p) for p in params)


def tuned_filter_admittance(settings: Settings, h_tune, x_cap,
                            quality: float = 30.0, device=None) -> Cx:
    """``Y_f(h)`` (H,) of a single-tuned series R-L-C shunt branch:
    capacitive reactance ``x_cap`` at the fundamental, ``X_L = x_cap /
    h_tune²``, ``R = sqrt(X_L·x_cap) / quality``.  (K,) parameters give a
    (K, H) bank.  On the parameters' device, or ``device`` (default: the
    CUDA card) for plain numbers."""
    h, h_tune, x_cap, quality = _filter_inputs(settings, device, h_tune,
                                               x_cap, quality)
    lead = torch.broadcast_shapes(h_tune.shape, x_cap.shape)
    x_l = x_cap / (h_tune * h_tune)
    r = (torch.sqrt(x_l * x_cap) / quality)[..., None]
    x = x_l[..., None] * h - x_cap[..., None] / h
    d = r * r + x * x
    return Cx((r / d).expand(*lead, h.shape[0]),
              (-x / d).expand(*lead, h.shape[0]))


def highpass_filter_admittance(settings: Settings, h_corner, x_cap,
                               m: float = 1.0, device=None) -> Cx:
    """``Y_f(h)`` (H,) of a second-order damped high-pass shunt filter:
    a series capacitor (``x_cap`` at the fundamental) into R parallel L,
    ``X_L = x_cap / h_corner²``, ``R = m·h_corner·X_L``.  Conventions of
    :func:`tuned_filter_admittance`."""
    h, h_corner, x_cap, m = _filter_inputs(settings, device, h_corner,
                                           x_cap, m)
    lead = torch.broadcast_shapes(h_corner.shape, x_cap.shape)
    x_l = x_cap / (h_corner * h_corner)
    R = (m * h_corner * x_l)[..., None]
    X = x_l[..., None] * h                           # inductor at order h
    d = R * R + X * X
    # Z = -j·x_cap/h  +  (R·X² + j·R²·X) / (R² + X²)
    z_re = R * X * X / d
    z_im = R * R * X / d - x_cap[..., None] / h
    dz = z_re * z_re + z_im * z_im
    return Cx((z_re / dz).expand(*lead, h.shape[0]),
              (-z_im / dz).expand(*lead, h.shape[0]))


def ctype_filter_admittance(settings: Settings, h_tune, x_cap,
                            quality: float = 2.0, device=None) -> Cx:
    """``Y_f(h)`` (H,) of a C-type damped shunt filter: the main capacitor
    (``x_cap``) in series with R parallel (L series C₂), L-C₂ tuned to the
    fundamental, the filter series-resonant at ``h_tune``
    (``x_l = x_cap / (h_tune² − 1)``), ``R = quality·h_tune·x_l``.
    Conventions of :func:`tuned_filter_admittance`."""
    h, h_tune, x_cap, quality = _filter_inputs(settings, device, h_tune,
                                               x_cap, quality)
    lead = torch.broadcast_shapes(h_tune.shape, x_cap.shape)
    x_l = x_cap / (h_tune * h_tune - 1.0)
    R = (quality * h_tune * x_l)[..., None]
    X_aux = x_l[..., None] * (h - 1.0 / h)           # j(h·x_l − x_c2/h)
    d = R * R + X_aux * X_aux
    z_re = R * X_aux * X_aux / d
    z_im = R * R * X_aux / d - x_cap[..., None] / h
    dz = z_re * z_re + z_im * z_im
    return Cx((z_re / dz).expand(*lead, h.shape[0]),
              (-z_im / dz).expand(*lead, h.shape[0]))


def _one_hot(n: int, bus, like: torch.Tensor) -> torch.Tensor:
    return (torch.arange(n, device=like.device) == bus).to(like.dtype)


def install_shunt(Y: Cx, bus: int, y_shunt: Cx) -> Cx:
    """``Y`` with the (H,) shunt admittance ``y_shunt`` added at
    ``bus``'s diagonal; feeds any ``Y=`` override."""
    e = _one_hot(Y.shape[-1], int(bus), Y.re)
    E = e[:, None] * e[None, :]
    return Cx(Y.re + y_shunt.re[:, None, None] * E,
              Y.im + y_shunt.im[:, None, None] * E)


def install_shunts(Y: Cx, buses, y_shunts: Cx) -> Cx:
    """:func:`install_shunt` for a bank: the (K, H) rows of ``y_shunts``
    added at ``buses`` in order (repeated buses accumulate)."""
    for k, b in enumerate(buses):
        Y = install_shunt(Y, int(b), y_shunts[k])
    return Y


def _interp(x, xp, fp):
    """``jnp.interp``: piecewise-linear ``fp(xp)`` at ``x``, held at the
    end values outside ``xp``; ``fp`` (..., len(xp))."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[..., i - 1],
                    fp[..., i - 1] + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def grid_ybus(net: Network, settings: Settings, h_grid: Sequence[float],
              devices=None) -> Tuple[Settings, Cx]:
    """(dense_settings, Y) on an arbitrary (float) order grid: the Ybus
    assembly at the grid's orders, and the Norton h-diagonal of
    ``devices`` interpolated linearly from ``settings.harmonics`` onto
    it."""
    hs = tuple(float(h) for h in h_grid)
    dense = settings.with_(harmonics=hs)
    Y = build_ybus(net, dense)
    if devices is not None and devices.n_devices:
        yn = _norton_diag(devices)
        rd, dv = settings.real_dtype, net.device
        h0 = torch.tensor(settings.harmonics, dtype=rd, device=dv)
        hq = torch.tensor(hs, dtype=rd, device=dv)
        yn = Cx(_interp(hq, h0, yn.re), _interp(hq, h0, yn.im))
        Y = _fold_norton(Y, net, yn)
    return dense, Y


def frequency_scan(net: Network, settings: Settings,
                   h_grid: Sequence[float], devices=None,
                   ground_slack: bool = True) -> torch.Tensor:
    """Driving-point ``|Z_kk|`` on a dense (float) order grid, (K, n):
    the Ybus re-assembled at fractional orders, which finds a resonance
    between the harmonic orders the solver samples."""
    dense, Y = grid_ybus(net, settings, h_grid, devices=devices)
    return _diag_abs(impedance_scan(net, dense, Y=Y,
                                    ground_slack=ground_slack))


def distortion_contributions(net: Network, devices, settings: Settings,
                             Y: Optional[Cx] = None) -> Cx:
    """Per-device harmonic voltage contributions, (H, n, n_nl):
    ``contrib[h, j, d] = −Z_op(h)[j, bus_d]·I_N[d](h)`` through the
    operational network (``ground_slack=False``); for uncoupled devices
    they superpose to the solved harmonic voltages."""
    Z = impedance_scan(net, settings, Y=Y, devices=devices,
                       ground_slack=False)
    Zc = Z[:, :, net.m:net.m + devices.n_devices]          # (H, n, n_nl)
    IN = devices.I_N                                       # (n_nl, H)
    re_d, im_d = IN.re.T[:, None, :], IN.im.T[:, None, :]
    return Cx(-(Zc.re * re_d - Zc.im * im_d),
              -(Zc.re * im_d + Zc.im * re_d))
