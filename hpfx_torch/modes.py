"""Harmonic resonance mode analysis (RMA), the port of :mod:`hpfx.modes`.

A parallel resonance is a near-singularity of ``Y(h)``: the critical mode
is its smallest-|lambda| eigenpair, ``z_modal = 1/|lambda_min|`` peaks at
the resonant order, the participation factors ``PF_b = (v_b·w_b) /
(wᵀv)`` localize it, and ``d lambda / d p = wᵀ (dY/dp) v / (wᵀv)`` ranks
the components that move it (Xu, Huang & Cui, IEEE Trans. Power Delivery
20(2), 2005).

The smallest eigenpair comes from batched inverse iteration: each step
is one split-complex block solve (:func:`hpfx_torch.cx.solve`,
``torch.linalg.solve``) batched over the orders, a fixed number of
steps, then Rayleigh-shifted refinement.  :func:`modal_spectrum` is the
full host-side decomposition (numpy LAPACK) for offline study and as the
test oracle.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .impedance import _fold_norton, _interp, _norton_diag, grid_ybus
from .network import Network
from .ybus import build_ybus

__all__ = ["critical_mode", "modal_scan", "modal_peaks",
           "eigen_sensitivity", "modal_spectrum", "ModalScan",
           "CriticalMode"]


class CriticalMode(NamedTuple):
    """Smallest-|lambda| eigenpair of a batch of admittance matrices:
    ``lam`` (split-complex, the batch's shape), right/left eigenvectors
    ``v``/``w`` (unit 2-norm, each one's largest entry real-positive),
    ``participation`` (v ⊙ w)/(wᵀv) and ``residual``
    ‖Yv − lam·v‖ / ‖lam·v‖."""
    lam: Cx
    v: Cx
    w: Cx
    participation: Cx
    residual: torch.Tensor

    @property
    def z_modal(self) -> torch.Tensor:
        """Modal impedance ``1/|lambda|``."""
        return 1.0 / self.lam.abs()


def _normalize(v: Cx) -> Cx:
    n2 = torch.sum(v.abs2(), dim=-1, keepdim=True)
    return v * (1.0 / torch.sqrt(n2))


def _fix_phase(v: Cx) -> Cx:
    """Each vector rotated so its largest-magnitude entry is real-positive
    (eigenvectors are defined up to phase)."""
    k = torch.argmax(v.abs2(), dim=-1, keepdim=True)
    re = torch.gather(v.re, -1, k)
    im = torch.gather(v.im, -1, k)
    return v * Cx(re, -im) * (1.0 / torch.sqrt(re * re + im * im))


def _dot(a: Cx, b: Cx) -> Cx:
    """Bilinear (transpose, not conjugate) product ``aᵀb`` over the last
    axis: left and right eigenvectors are orthogonal under it."""
    return Cx(torch.sum(a.re * b.re - a.im * b.im, dim=-1),
              torch.sum(a.re * b.im + a.im * b.re, dim=-1))


def _inverse_iteration(Y: Cx, iters: int) -> Cx:
    """``iters`` steps of v <- normalize(Y⁻¹ v) from a flat start (a small
    index ramp in the imaginary part), batched over Y's leading axes."""
    n = Y.shape[-1]
    lead = Y.shape[:-2]
    rd, dv = Y.re.dtype, Y.re.device
    v = _normalize(Cx(torch.ones(n, dtype=rd, device=dv).expand(*lead, n),
                      torch.linspace(0.0, 0.1, n, dtype=rd, device=dv)
                      .expand(*lead, n)))
    for _ in range(iters):
        v = _normalize(cx.solve(Y, v))
    return v


def _rayleigh(Y: Cx, v: Cx) -> Cx:
    """Rayleigh quotient ``vᴴYv / vᴴv``."""
    Yv = cx.einsum("...ij,...j->...i", Y, v)
    return _dot(v.conj(), Yv) / _dot(v.conj(), v)


def _shift_solve(Y: Cx, lam: Cx, v: Cx, relax: float = 1e-9) -> Cx:
    """One step of shifted inverse iteration,
    ``v <- normalize((Y − (1+relax)·lam·I)⁻¹ v)``; a non-finite step keeps
    ``v``."""
    eye = torch.eye(Y.shape[-1], dtype=Y.re.dtype, device=Y.re.device)
    sh = lam * (1.0 + relax)
    Ys = Cx(Y.re - sh.re[..., None, None] * eye,
            Y.im - sh.im[..., None, None] * eye)
    u = _normalize(cx.solve(Ys, v))
    ok = (torch.isfinite(u.re).all(-1, keepdim=True)
          & torch.isfinite(u.im).all(-1, keepdim=True))
    return cx.where(ok, u, v)


def critical_mode(Y: Cx, iters: int = 24, refine: int = 2,
                  symmetric: bool = False) -> CriticalMode:
    """Smallest-|lambda| eigenpair of ``Y`` (..., n, n): ``iters`` steps of
    batched inverse iteration, then ``refine`` Rayleigh-shifted steps.
    ``symmetric=True`` takes ``w = v`` (reciprocal networks).  A large
    ``residual`` flags |lambda_1| = |lambda_2|."""
    v = _inverse_iteration(Y, iters)
    lam = _rayleigh(Y, v)
    for _ in range(refine):
        v = _shift_solve(Y, lam, v)
        lam = _rayleigh(Y, v)
    v = _fix_phase(v)
    if symmetric:
        w = v
    else:
        Yt = Y.mT
        w = v.conj()
        for _ in range(max(refine, 2)):
            w = _shift_solve(Yt, lam, w)
        w = _fix_phase(w)
    Yv = cx.einsum("...ij,...j->...i", Y, v)
    res = Yv - v * Cx(lam.re[..., None], lam.im[..., None])
    residual = torch.sqrt(torch.sum(res.abs2(), dim=-1)) / lam.abs()
    wv = _dot(w, v)
    participation = (v * w) / Cx(wv.re[..., None], wv.im[..., None])
    return CriticalMode(lam=lam, v=v, w=w, participation=participation,
                        residual=residual)


class ModalScan(NamedTuple):
    """:func:`modal_scan` over K grid orders on an n-bus network: ``order``
    (K,), ``z_modal`` (K,), ``lam`` (K,), ``participation`` (K, n) |PF|
    (the grounded slack's row 0), ``critical_bus`` (K,) and ``residual``
    (K,)."""
    order: torch.Tensor
    z_modal: torch.Tensor
    lam: Cx
    participation: torch.Tensor
    critical_bus: torch.Tensor
    residual: torch.Tensor


def _reciprocal(net: Network) -> bool:
    return bool((net.line_shift == 0.0).all())


def modal_scan(net: Network, settings: Settings,
               h_grid: Optional[Sequence[float]] = None, devices=None,
               ground_slack: bool = True, iters: int = 24,
               symmetric: Optional[bool] = None) -> ModalScan:
    """The critical eigenpair of ``Y(h)`` over an order grid (default
    ``settings.harmonics``), the modal twin of ``frequency_scan``;
    ``devices`` folds the converters' Norton h-diagonal in (interpolated
    onto off-grid orders); ``ground_slack`` removes the slack row and
    column; ``symmetric`` defaults to True when no line shifts phase."""
    if h_grid is None:
        h_grid = settings.harmonics
    if symmetric is None:
        symmetric = _reciprocal(net)
    _, Y = grid_ybus(net, settings, h_grid, devices=devices)
    if ground_slack:
        Y = Y[:, 1:, 1:]
    mode = critical_mode(Y, iters=iters, symmetric=symmetric)
    pf = mode.participation.abs()
    if ground_slack:
        pf = torch.nn.functional.pad(pf, (1, 0))
    return ModalScan(order=torch.tensor([float(h) for h in h_grid],
                                        dtype=settings.real_dtype,
                                        device=net.device),
                     z_modal=mode.z_modal, lam=mode.lam,
                     participation=pf,
                     critical_bus=torch.argmax(pf, dim=-1),
                     residual=mode.residual)


def modal_peaks(scan: ModalScan) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``(is_peak, h_res, bus_res)``: the strict local maxima of
    ``z_modal`` over the grid (endpoints count when they dominate their
    neighbour), the order of the global maximum and its critical bus."""
    z = scan.z_modal
    one = torch.ones_like(z[:1], dtype=torch.bool)
    up = torch.cat([one, z[1:] > z[:-1]])
    down = torch.cat([z[:-1] > z[1:], one])
    k = torch.argmax(z)
    return up & down, scan.order[k], scan.critical_bus[k]


def eigen_sensitivity(net: Network, settings: Settings, order: float,
                      devices=None, ground_slack: bool = True,
                      iters: int = 24, symmetric: Optional[bool] = None):
    """First-order sensitivities of the critical eigenvalue at ``order`` to
    ``line_R``, ``line_X``, ``line_B`` and ``bus_Xsh``:
    ``d lambda / d p = wᵀ (dY/dp) v / (wᵀv)`` with the eigenvectors frozen,
    by ``torch.func.jacrev`` through ``build_ybus``.  Returns ``(lam,
    sens)``, ``sens[name]`` holding ``dlam`` (split-complex, the
    parameter's shape) and ``dz_modal`` (the change of ``1/|lambda|``)."""
    one = settings.with_(harmonics=(float(order),))
    if symmetric is None:
        symmetric = _reciprocal(net)

    yn = None
    if devices is not None and devices.n_devices:
        yn0 = _norton_diag(devices)
        rd, dv = settings.real_dtype, net.device
        h0 = torch.tensor(settings.harmonics, dtype=rd, device=dv)
        hq = torch.tensor([float(order)], dtype=rd, device=dv)
        yn = Cx(_interp(hq, h0, yn0.re), _interp(hq, h0, yn0.im))

    def assemble(params):
        n2 = dataclasses.replace(net, **params)
        Y = build_ybus(n2, one)
        if yn is not None:
            Y = _fold_norton(Y, n2, yn)
        if ground_slack:
            Y = Y[:, 1:, 1:]
        return Y[0]

    params0 = {k: getattr(net, k)
               for k in ("line_R", "line_X", "line_B", "bus_Xsh")}
    mode = critical_mode(assemble(params0), iters=iters, symmetric=symmetric)
    v, w = mode.v, mode.w
    wv = _dot(w, v)

    def lam_fn(params):
        lam = _dot(w, cx.einsum("...ij,...j->...i", assemble(params), v)) / wv
        return lam.re, lam.im

    dre, dim = torch.func.jacrev(lam_fn)(params0)
    lam = mode.lam
    a2 = lam.abs2()
    sens = {}
    for k in params0:
        dlam = Cx(dre[k], dim[k])
        # d(1/|lam|)/dp = -(lam_re·dre + lam_im·dim) / |lam|^3
        dz = -(lam.re * dlam.re + lam.im * dlam.im) / (a2 * torch.sqrt(a2))
        sens[k] = {"dlam": dlam, "dz_modal": dz}
    return lam, sens


def modal_spectrum(Y) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full modal decomposition of one (n, n) admittance matrix (a
    ``Cx`` or a complex numpy array) on the host: eigenvalues (n,), right
    eigenvectors as columns (n, n) and participations ``PF[b, m]``
    (columns sum to 1), by ascending |lambda|."""
    if isinstance(Y, Cx):
        Y = Y.re.detach().cpu().numpy() + 1j * Y.im.detach().cpu().numpy()
    lam, V = np.linalg.eig(Y)
    # rows of V^{-1} are the (bilinearly normalized) left vectors
    W = np.linalg.inv(V)
    order = np.argsort(np.abs(lam))
    lam, V, W = lam[order], V[:, order], W[order, :]
    return lam, V, V * W.T
