"""Unbalanced three-phase harmonic penetration, the port of
:mod:`hpfx.threephase`.

In the phase (abc) frame, for a network whose every element is described
by its sequence admittances, the 3n×3n nodal matrix is

    Y_abc = Y1 ⊗ (I − M0) + Y0 ⊗ M0,      M0 = ones(3, 3)/3,

from the positive-sequence admittance (:func:`hpfx_torch.ybus.build_ybus`)
and the zero-sequence companion (:func:`hpfx_torch.sequence.
zero_sequence_network`, with blocked delta windings and grounded
neutrals) (:func:`abc_admittance`).  Each Norton device's spectrum is
expanded to its three phases with the balanced rotation e^{∓j·h·2π/3},
then made unbalanced by per-device-phase factors; 3-wire (delta) devices
lose their zero-sequence component (:func:`phase_injections`).  Per
order, ``(Y_abc − Y_N,abc)·V = −I_N,abc`` with the slack's phases
grounded, one batched split-complex solve (:func:`solve_unbalanced`);
exact for uncoupled devices.  The injections, and so the solve, take
leading draw axes: :func:`allocation_study` solves all its seeded draws
in one batch.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .devices import DeviceSet
from .network import Network
from .sequence import (_dense_from_line, _grounding_diag, _keep,
                       _zero_companion)
from .ybus import build_line_ybus, build_ybus

__all__ = ["abc_admittance", "phase_injections", "solve_unbalanced",
           "sequence_voltages", "unbalance_factors", "allocation_study",
           "line_phase_flows", "ThreePhaseResult", "AllocationStudy",
           "PhaseFlows"]

#: real zero-sequence projector M0 = A e0 e0^T A^{-1} = ones/3
_M0 = np.full((3, 3), 1.0 / 3.0)


def _zero_sequence_dense(net: Network, settings: Settings, net0, *,
                         blocked: Sequence[int],
                         bus_Xg: Optional[Mapping[int, float]],
                         **zero_kw) -> Cx:
    """Dense (H, n, n) zero-sequence admittance at every order (an
    unbalanced injection excites the zero-sequence network at any
    order)."""
    net0, keep = _zero_companion(net, settings, net0, blocked, zero_kw)
    lineY0 = build_line_ybus(net0, settings)
    d0 = lineY0.d
    g = _grounding_diag(settings, bus_Xg, net.n, net.device)
    if g is not None:
        d0 = d0 + g
    return _dense_from_line(lineY0._replace(Ys=lineY0.Ys * keep, d=d0),
                            net.n)


def _kron3(Y: Cx, M: np.ndarray) -> Cx:
    """(H, n, n) ⊗ (3, 3 real) -> (H, 3n, 3n), bus k's phases on rows
    3k..3k+2."""
    H, n = Y.shape[0], Y.shape[1]
    Mt = torch.as_tensor(M, dtype=Y.dtype, device=Y.device)
    k = lambda a: torch.einsum("hjk,pq->hjpkq", a, Mt).reshape(
        H, 3 * n, 3 * n)
    return Cx(k(Y.re), k(Y.im))


def abc_admittance(net: Network, settings: Settings, net0=None, *,
                   blocked: Sequence[int] = (),
                   bus_Xg: Optional[Mapping[int, float]] = None,
                   **zero_kw) -> Cx:
    """Phase-frame nodal admittance, (H, 3n, 3n):
    ``Y1 ⊗ (I − M0) + Y0 ⊗ M0`` (``blocked`` lines lose series and shunt
    in Y0; ``bus_Xg`` adds grounded-neutral paths)."""
    Y1 = build_ybus(net, settings)
    Y0 = _zero_sequence_dense(net, settings, net0, blocked=blocked,
                              bus_Xg=bus_Xg, **zero_kw)
    return _kron3(Y1, np.eye(3) - _M0) + _kron3(Y0, _M0)


def _phase_factor(x, n_nl: int, like: torch.Tensor) -> torch.Tensor:
    """Per-device-phase factors broadcast to (..., n_nl, 3)."""
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return t.expand(t.shape[:-2] + (n_nl, 3)) if t.ndim > 2 \
        else t.expand(n_nl, 3)


def phase_injections(devices: DeviceSet, settings: Settings, *,
                     delta: Sequence[int] = (),
                     mag=None, ang=None) -> Cx:
    """Per-phase Norton current spectra, (..., H, n_nl, 3): phase a the
    device's ``I_N``, phases b/c rotated by ∓ h·120°; ``mag``/``ang``
    (..., n_nl, 3) (or broadcastable) per-device-phase magnitude factors
    and angle offsets [rad], any leading axes draws; ``delta`` devices
    lose their zero-sequence component."""
    rd = settings.real_dtype
    I_N = devices.I_N
    h = torch.tensor(settings.harmonics, dtype=rd,
                     device=I_N.device)[:, None]                 # (H, 1)
    n_nl = devices.n_devices
    rot = (2.0 * math.pi / 3.0) * h
    phase_ang = -rot[..., None] * torch.tensor([0.0, 1.0, 2.0], dtype=rd,
                                               device=h.device)
    I = Cx(I_N.re.T[:, :, None], I_N.im.T[:, :, None]) * cx.expj(phase_ang)
    if mag is not None:
        I = I * _phase_factor(mag, n_nl, h)[..., None, :, :]
    if ang is not None:
        I = I * cx.expj(_phase_factor(ang, n_nl, h)[..., None, :, :])
    if delta:
        dm = (1.0 - _keep(n_nl, delta, h))[None, :, None]
        # zero-sequence removal: I <- I - mean over the phases
        mean = Cx(I.re.mean(dim=-1, keepdim=True),
                  I.im.mean(dim=-1, keepdim=True))
        I = Cx(I.re - dm * mean.re, I.im - dm * mean.im)
    return I


def _norton_phase_diag(devices: DeviceSet) -> Cx:
    """Per-device per-order Norton admittance, (n_nl, H): the h-diagonal
    of coupled devices."""
    yn = devices.Y_N
    if devices.coupled:
        yn = Cx(torch.diagonal(yn.re, dim1=-2, dim2=-1),
                torch.diagonal(yn.im, dim1=-2, dim2=-1))
    return yn


class ThreePhaseResult(NamedTuple):
    """Solved phase-frame harmonic voltages ``V`` (..., H, n, 3) (the
    grounded slack's rows zero), the injections ``I`` (..., H, n_nl, 3)
    and the ``orders`` (H,)."""
    V: Cx
    I: Cx
    orders: torch.Tensor


def solve_unbalanced(net: Network, devices: DeviceSet,
                     settings: Settings, *, net0=None,
                     blocked: Sequence[int] = (),
                     bus_Xg: Optional[Mapping[int, float]] = None,
                     delta: Sequence[int] = (),
                     mag=None, ang=None, I_abc: Optional[Cx] = None,
                     Yabc: Optional[Cx] = None,
                     ground_slack: bool = True,
                     **zero_kw) -> ThreePhaseResult:
    """Unbalanced three-phase harmonic penetration solve:
    ``(Y_abc − Y_N,abc)·V(h) = −I(h)`` for every order (and every draw of
    the injections' leading axes) in one batched block solve, wye devices'
    admittances as ``y·I`` per phase block, delta ones as ``y·(I − M0)``.
    ``I_abc`` overrides :func:`phase_injections` (``mag``/``ang``/``delta``
    forwarded); ``Yabc`` overrides :func:`abc_admittance`.
    ``ground_slack`` (default) shorts the slack's three phases for the
    harmonics; without it the raw balance is solved, only valid on rows
    tied to ground (not h = 1)."""
    if Yabc is None:
        Yabc = abc_admittance(net, settings, net0, blocked=blocked,
                              bus_Xg=bus_Xg, **zero_kw)
    elif net0 is not None or zero_kw:
        raise ValueError("pass either Yabc or assembly parameters")
    rd, dv = settings.real_dtype, net.device
    H = len(settings.harmonics)
    n, n_nl = net.n, devices.n_devices
    if I_abc is None:
        I_abc = phase_injections(devices, settings, delta=delta,
                                 mag=mag, ang=ang)
    # the Norton admittances into each device bus's 3x3 phase block:
    # wye·y·I + delta·y·(I − M0)
    yn = _norton_phase_diag(devices)                          # (n_nl, H)
    t = lambda a: torch.as_tensor(a, dtype=rd, device=dv)
    wye = _keep(n_nl, delta, yn.re)[:, None, None]
    blk = wye * t(np.eye(3)) + (1.0 - wye) * t(np.eye(3) - _M0)
    buses = torch.as_tensor(net.m + np.arange(n_nl), device=dv)
    Y = Yabc.reshape(H, n, 3, n, 3)
    Yre, Yim = Y.re.clone(), Y.im.clone()
    Yre[:, buses, :, buses, :] += torch.movedim(
        -yn.re.T[:, :, None, None] * blk, 1, 0)
    Yim[:, buses, :, buses, :] += torch.movedim(
        -yn.im.T[:, :, None, None] * blk, 1, 0)
    Yf = Cx(Yre, Yim).reshape(H, 3 * n, 3 * n)
    lead = I_abc.shape[:-3]
    rhs = cx.zeros(lead + (H, n, 3), rd, dv)
    rhs.re[..., buses, :] = -I_abc.re
    rhs.im[..., buses, :] = -I_abc.im
    b = rhs.reshape(*lead, H, 3 * n)
    col = lambda z: Cx(z.re[..., None], z.im[..., None])
    if ground_slack:
        # the slack's three phase nodes are shorts for harmonics: reduce,
        # solve, re-embed zeros
        Vr = cx.solve(Yf[:, 3:, 3:], col(b[..., 3:]))
        V = cx.zeros(lead + (H, 3 * n), rd, dv)
        V.re[..., 3:] = Vr.re[..., 0]
        V.im[..., 3:] = Vr.im[..., 0]
    else:
        Vr = cx.solve(Yf, col(b))
        V = Cx(Vr.re[..., 0], Vr.im[..., 0])
    return ThreePhaseResult(V=V.reshape(*lead, H, n, 3), I=I_abc,
                            orders=t(settings.harmonics))


def sequence_voltages(res: ThreePhaseResult) -> Tuple[Cx, Cx, Cx]:
    """Fortescue components (V0, V1, V2), each (..., H, n), of a solved
    phase-frame result."""
    from .sequence import sequence_components
    seq = sequence_components(res.V[..., 0], res.V[..., 1], res.V[..., 2])
    return seq.zero, seq.positive, seq.negative


def unbalance_factors(res: ThreePhaseResult, eps: float = 1e-30,
                      harmonics: Optional[Sequence[float]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-order, per-bus foreign-sequence fractions of the harmonic
    voltages: for each order's balanced class cls (h mod 3), the
    magnitudes of sequences cls+1 and cls+2 (mod 3) over
    sqrt(|V0|² + |V1|² + |V2|²); 0 where an order carries no voltage.
    ``harmonics`` defaults to ``res.orders``."""
    v0, v1, v2 = sequence_voltages(res)
    m2 = torch.stack([v0.abs2(), v1.abs2(), v2.abs2()])    # (3, ..., H, n)
    hs = (res.orders.detach().cpu().numpy() if harmonics is None
          else np.asarray(harmonics, float))
    cls = [int(h) % 3 for h in hs]
    pick = lambda shift: torch.stack(
        [m2[(c + shift) % 3, ..., r, :] for r, c in enumerate(cls)], dim=-2)
    tot = torch.sum(m2, dim=0)
    total = torch.sqrt(torch.clamp_min(tot, eps))
    nz = tot > eps
    zero = torch.zeros((), dtype=tot.dtype, device=tot.device)
    return (torch.where(nz, torch.sqrt(pick(1)) / total, zero),
            torch.where(nz, torch.sqrt(pick(2)) / total, zero))


class AllocationStudy(NamedTuple):
    """:func:`allocation_study`'s result: the quantiles ``q`` (Q,), the
    foreign-sequence fractions' ``u0_q``/``u2_q`` and the worst phase
    magnitude's ``vmag_q``, each (Q, H, n), and the ``orders`` (H,)."""
    q: torch.Tensor
    u0_q: torch.Tensor
    u2_q: torch.Tensor
    vmag_q: torch.Tensor
    orders: torch.Tensor


def allocation_study(net: Network, devices: DeviceSet,
                     settings: Settings, *, n_draws: int = 256,
                     sigma_mag: float = 0.2, sigma_ang: float = 0.1,
                     seed: int = 0, q: Sequence[float] = (0.5, 0.95),
                     net0=None, blocked: Sequence[int] = (),
                     bus_Xg: Optional[Mapping[int, float]] = None,
                     delta: Sequence[int] = (),
                     **zero_kw) -> AllocationStudy:
    """Monte-Carlo study of random per-phase device allocation:
    ``n_draws`` lognormal magnitude factors (spread ``sigma_mag``, mean 1)
    and normal angle offsets (``sigma_ang`` rad), drawn by numpy from
    ``seed`` as the JAX package draws them, all solved in one batch on
    the admittance assembled once, reduced to quantiles of the
    foreign-sequence fractions and of the worst phase magnitude."""
    rng = np.random.default_rng(seed)
    rd, dv = settings.real_dtype, net.device
    n_nl = devices.n_devices
    t = lambda a: torch.as_tensor(a, dtype=rd, device=dv)
    mag = t(rng.lognormal(-0.5 * sigma_mag ** 2, sigma_mag,
                          (n_draws, n_nl, 3)))
    ang = t(rng.normal(0.0, sigma_ang, (n_draws, n_nl, 3)))
    Yabc = abc_admittance(net, settings, net0, blocked=blocked,
                          bus_Xg=bus_Xg, **zero_kw)
    res = solve_unbalanced(net, devices, settings, Yabc=Yabc, delta=delta,
                           mag=mag, ang=ang)
    u0, u2 = unbalance_factors(res, harmonics=settings.harmonics)
    vmag = res.V.abs().amax(dim=-1)                  # worst phase, (D, H, n)
    qs = t(q)
    return AllocationStudy(
        q=qs, u0_q=torch.quantile(u0, qs, dim=0),
        u2_q=torch.quantile(u2, qs, dim=0),
        vmag_q=torch.quantile(vmag, qs, dim=0),
        orders=t(settings.harmonics))


class PhaseFlows(NamedTuple):
    """Per-line, per-phase branch currents of a solved abc case:
    ``I_f``/``I_t`` (H, L, 3) into the line at each end, ``residual_f``
    (H, L) |I_a + I_b + I_c| at the from end (the neutral/earth return)
    and its RMS over the orders ``residual_rms`` (L,)."""
    I_f: Cx
    I_t: Cx
    residual_f: torch.Tensor
    residual_rms: torch.Tensor


def _blend_apply(y1: Cx, y0: Cx, v: Cx) -> Cx:
    """``y1·(I − M0) + y0·M0`` applied to a (H, L, 3) phase vector."""
    mean = Cx(v.re.mean(dim=-1, keepdim=True),
              v.im.mean(dim=-1, keepdim=True))
    dev_ = Cx(v.re - mean.re, v.im - mean.im)
    y1e = Cx(y1.re[..., None], y1.im[..., None])
    y0e = Cx(y0.re[..., None], y0.im[..., None])
    return y1e * dev_ + y0e * mean


def _series_shunt(net: Network, settings: Settings):
    """Per-line series admittance Ys(h) and pi shunt Ysh(h), (H, L)."""
    rd = settings.real_dtype
    h = torch.tensor(settings.harmonics, dtype=rd,
                     device=net.device)[:, None]
    R, X = net.line_R, net.line_X
    Xh = X * h
    d = R * R + Xh * Xh
    return (Cx(R / d, -Xh / d),
            Cx((net.line_G / 2.0).expand(Xh.shape), h * net.line_B / 2.0))


def line_phase_flows(net: Network, settings: Settings,
                     res: ThreePhaseResult, net0=None, *,
                     blocked: Sequence[int] = (),
                     **zero_kw) -> PhaseFlows:
    """Per-phase branch currents and neutral (residual) flows of a solved
    case, each coefficient of ``hpfx_torch.flows.line_flows``' algebra
    blended between its positive- and zero-sequence values; pass the
    solve's ``net0``/``blocked``/``zero_kw``."""
    net0, keep = _zero_companion(net, settings, net0, blocked, zero_kw)
    Ys1, Ysh1 = _series_shunt(net, settings)
    Ys0, Ysh0 = _series_shunt(net0, settings)
    Ys0 = Ys0 * keep

    tau = net.line_tau
    inv_t_ft = cx.expj(net.line_shift) * (1.0 / tau)
    inv_t_tf = cx.expj(-net.line_shift) * (1.0 / tau)
    a_ff = 1.0 / (tau * tau)

    f, t = net.line_from, net.line_to
    V_f = res.V[:, f, :]                                     # (H, L, 3)
    V_t = res.V[:, t, :]
    I_f = (_blend_apply((Ys1 + Ysh1) * a_ff, (Ys0 + Ysh0) * a_ff, V_f)
           - _blend_apply(Ys1 * inv_t_ft, Ys0 * inv_t_ft, V_t))
    I_t = (_blend_apply(Ys1 + Ysh1, Ys0 + Ysh0, V_t)
           - _blend_apply(Ys1 * inv_t_tf, Ys0 * inv_t_tf, V_f))
    rmag = Cx(I_f.re.sum(dim=-1), I_f.im.sum(dim=-1)).abs()
    return PhaseFlows(I_f=I_f, I_t=I_t, residual_f=rmag,
                      residual_rms=torch.sqrt(torch.sum(rmag * rmag, dim=0)))
