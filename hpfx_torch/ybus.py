"""Per-harmonic admittance (Ybus) assembly, split-complex.

The PyTorch counterpart of :mod:`hpfx.ybus`: the dense ``(H, n, n)``
tensor of every harmonic order, and the line-structured form
(:class:`LineYbus`) behind the cancellation-free mismatch
(``hpfx_torch.lanes.stable_matvec_lanes``).  Same physics: series
admittance 1/(R + j·X·h) per line, pi-line shunts (G + j·h·B)/2 at each
end, bus shunt reactances on the harmonic orders only, and the pi-model
transformer (tap on the from side) where a line carries tau/shift.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cx
from .config import Settings
from .cx import Cx
from .network import Network

_all = slice(None)


def _series(net: Network, settings: Settings, Rh=None, Ys=None, Ysh=None):
    """(h (H, 1), Ys (H, L), pi-shunt per end Ysh (H, L)).  ``Rh`` (H, L)
    replaces ``net.line_R`` per harmonic; ``Ys``/``Ysh`` replace the
    series admittance and the per-end shunt outright."""
    rd = settings.real_dtype
    h = torch.tensor(settings.harmonics, dtype=rd,
                     device=net.device)[:, None]
    Xh = net.line_X * h
    if Ys is None:
        R = net.line_R if Rh is None else torch.as_tensor(
            Rh, dtype=rd, device=net.device)
        d = R * R + Xh * Xh
        Ys = Cx(R / d, -Xh / d)                               # 1/(R+jXh)
    if Ysh is None:
        Ysh = Cx((net.line_G / 2.0).expand(Xh.shape), h * net.line_B / 2.0)
    return h, Ys, Ysh


def _shunt_ends(net: Network, settings: Settings):
    """Bus indices of each line's from/to shunt and the kept-line mask.
    ``compat_shunt_bug`` reproduces the reference's off-by-one (shunts on
    the bus whose index equals the endpoint's 1-based ID; endpoints past
    the last bus drop out)."""
    f, t = net.line_from, net.line_to
    if not settings.compat_shunt_bug:
        keep = torch.ones_like(f, dtype=torch.bool)
        return f, t, keep, keep
    return f + 1, t + 1, f + 1 < net.n, t + 1 < net.n


def _bus_shunt_im(net: Network, h):
    """Imaginary part of 1/(j·X_sh·h) on the harmonic orders (H, n)."""
    xsh = net.bus_Xsh[None, :]
    apply = (h != 1.0) & (xsh != 0.0)
    safe = torch.where(xsh != 0.0, xsh, torch.ones_like(xsh))
    return torch.where(apply, -1.0 / (safe * h), torch.zeros_like(safe * h))


def build_ybus(net: Network, settings: Settings, Rh=None, *,
               Ys: Cx = None, Ysh: Cx = None) -> Cx:
    """The dense (H, n, n) split-complex admittance tensor, one block per
    harmonic order in ``settings.harmonics``.

    ``Rh`` (H, L) overrides the series resistance per harmonic and line
    (frequency-dependent conductors); ``Ys``/``Ysh`` (split-complex
    (H, L)) replace the series admittance and the per-end pi shunt
    (G + j·h·B)/2 outright.  Taps, shifts and bus shunts still apply."""
    rd = settings.real_dtype
    n = net.n
    h, Ys, Ysh = _series(net, settings, Rh, Ys, Ysh)
    tau = net.line_tau
    inv_t_ft = cx.expj(net.line_shift) * (1.0 / tau)
    inv_t_tf = cx.expj(-net.line_shift) * (1.0 / tau)

    f, t = net.line_from, net.line_to
    Y = cx.zeros((len(settings.harmonics), n, n), rd, net.device)
    Y = Y.at_add((_all, f, t), -(Ys * inv_t_ft))
    Y = Y.at_add((_all, t, f), -(Ys * inv_t_tf))
    Y = Y.at_add((_all, f, f), Ys * (1.0 / (tau * tau)))
    Y = Y.at_add((_all, t, t), Ys)

    f_sh, t_sh, kf, kt = _shunt_ends(net, settings)
    a_f = 1.0 if settings.compat_shunt_bug else 1.0 / (tau * tau)
    Y = Y.at_add((_all, f_sh[kf], f_sh[kf]), (Ysh * a_f)[:, kf])
    Y = Y.at_add((_all, t_sh[kt], t_sh[kt]), Ysh[:, kt])

    y_sh_im = _bus_shunt_im(net, h)
    idx = torch.arange(n, device=net.device)
    return Y.at_add((_all, idx, idx), Cx(torch.zeros_like(y_sh_im), y_sh_im))


def resolve_ybus(net: Network, settings: Settings, Y=None):
    """``(Y, lineY, lineY_f)`` for a solver entry: ``None`` builds both
    forms from the network; a dense ``Cx`` comes with no line structure
    (the stable mismatch is then off); a ``(Y, lineY, lineY_f)`` triple
    carries its own consistent structures."""
    if Y is None:
        return build_ybus(net, settings), *line_ybus_pair(net, settings)
    if isinstance(Y, Cx):
        return Y, None, None
    Yd, lineY, lineY_f = Y
    if not isinstance(Yd, Cx):
        raise TypeError("Y must be None, a dense Cx, or a "
                        "(Y, lineY, lineY_f) triple")
    return Yd, lineY, lineY_f


def fold_ydiag(Y: Cx, Y_diag: Cx) -> Cx:
    """Add per-bus shunt admittances ``Y_diag`` (H, n) to the diagonal of
    the dense (H, n, n) admittance tensor (``hpfx.ybus.fold_ydiag``)."""
    idx = torch.arange(Y.shape[-1], device=Y.device)
    return Y.at_add((_all, idx, idx), Y_diag)


class LineYbus(NamedTuple):
    """Line-structured admittance (``hpfx.ybus.LineYbus``): ``Ys`` (H, L)
    series admittances, ``a_ff``/``inv_tau``/``shift`` (L,) tap/phase
    couplings, ``d`` (H, n) every diagonal-only term, ``f_idx``/``t_idx``
    (L,) endpoints."""

    Ys: Cx
    a_ff: torch.Tensor
    inv_tau: torch.Tensor
    shift: torch.Tensor
    d: Cx
    f_idx: torch.Tensor
    t_idx: torch.Tensor


def build_line_ybus(net: Network, settings: Settings, Rh=None, *,
                    Ys: Cx = None, Ysh: Cx = None) -> LineYbus:
    """The line-structured form of the same physics as :func:`build_ybus`;
    ``Rh``/``Ys``/``Ysh`` as there."""
    rd = settings.real_dtype
    H = len(settings.harmonics)
    h, Ys, Ysh = _series(net, settings, Rh, Ys, Ysh)
    tau = net.line_tau
    a_ff = 1.0 / (tau * tau)

    d = cx.zeros((H, net.n), rd, net.device)
    f_sh, t_sh, kf, kt = _shunt_ends(net, settings)
    a_f = 1.0 if settings.compat_shunt_bug else a_ff
    d = d.at_add((_all, f_sh[kf]), (Ysh * a_f)[:, kf])
    d = d.at_add((_all, t_sh[kt]), Ysh[:, kt])
    y_sh_im = _bus_shunt_im(net, h)
    d = d + Cx(torch.zeros_like(y_sh_im), y_sh_im)
    return LineYbus(Ys=Ys, a_ff=a_ff, inv_tau=1.0 / tau,
                    shift=net.line_shift.to(rd), d=d,
                    f_idx=net.line_from, t_idx=net.line_to)


def line_ybus_pair(net: Network, settings: Settings, Rh=None, *,
                   Ys: Cx = None, Ysh: Cx = None):
    """(full, fundamental-sliced) LineYbus pair for the stable mismatch,
    or (None, None) when ``settings.stable_mismatch`` is off;
    ``Rh``/``Ys``/``Ysh`` as in :func:`build_ybus`."""
    if not settings.stable_mismatch:
        return None, None
    full = build_line_ybus(net, settings, Rh, Ys=Ys, Ysh=Ysh)
    fund = full._replace(Ys=full.Ys[:1], d=full.d[:1])
    return full, fund


def _polar_diff(mu_a, th_a, mu_b, th_b) -> Cx:
    """mu_a·e^{j th_a} − mu_b·e^{j th_b} without cancellation
    (``hpfx.ybus._polar_diff``): e^{j th_a}·[(mu_a − mu_b)
    + 2·mu_b·sin²(Δ/2) − j·mu_b·sin Δ] with Δ = th_b − th_a, so the
    rounding is relative to the difference, not to |V|."""
    dmu = mu_a - mu_b
    delta = th_b - th_a
    s_half = torch.sin(0.5 * delta)
    re_local = dmu + 2.0 * mu_b * s_half * s_half
    im_local = -mu_b * torch.sin(delta)
    return cx.expj(th_a) * Cx(re_local, im_local)


def incidence(f_idx, t_idx, n: int, dtype) -> torch.Tensor:
    """The (n, 2L) one-hot bus incidence of the lines' from ends, then
    their to ends: a product with it sums line flows into buses in an
    order that does not change from call to call on any device (a CUDA
    ``index_add`` adds repeated buses atomically, in a racing order).
    Built from the index tensors on their device, with no host sync."""
    buses = torch.arange(n, device=f_idx.device)[:, None]
    return torch.cat([f_idx[None, :] == buses, t_idx[None, :] == buses],
                     dim=1).to(dtype)


def stable_matvec(lineY: LineYbus, V_m, V_a) -> Cx:
    """Cancellation-free Y·V for (..., H, n) polar voltage spectra
    (``hpfx.ybus.stable_matvec``): per line Ys·(V_f/tau² − V_t·e^{j s}/tau)
    into the from bus and the mirror flow into the to bus, each voltage
    difference taken by :func:`_polar_diff` and summed into the buses by
    the :func:`incidence` product, plus the diagonal-only terms d·V.
    Leading axes are scenarios; ``Ys`` (..., H, L) and ``d`` (..., H, n)
    may carry them too (one network per scenario on shared endpoints)."""
    f, t = lineY.f_idx, lineY.t_idx
    Vm_f, Va_f = V_m[..., f], V_a[..., f]
    Vm_t, Va_t = V_m[..., t], V_a[..., t]
    flow_f = lineY.Ys * _polar_diff(Vm_f * lineY.a_ff, Va_f,
                                    Vm_t * lineY.inv_tau, Va_t + lineY.shift)
    flow_t = lineY.Ys * _polar_diff(Vm_t, Va_t, Vm_f * lineY.inv_tau,
                                    Va_f - lineY.shift)
    out = lineY.d * cx.polar(V_m, V_a)
    inc = incidence(f, t, V_m.shape[-1], V_m.dtype)
    acc = lambda a, b: torch.einsum("nl,...l->...n", inc,
                                    torch.cat([a, b], dim=-1))
    return out + Cx(acc(flow_f.re, flow_t.re), acc(flow_f.im, flow_t.im))
