"""Harmonically coupled Norton-equivalent (HCNE) power flow, the core
solver: the port of :mod:`hpfx.harmonic`.

Voltages are (H, n) split-complex spectra, harmonic-major, so flattening
row-major gives the reference's (harmonic, bus) state order and the dense
Jacobian compares entry for entry with the golden fixtures.  Every
function takes leading scenario axes: a single case has none, the
batch-major sweep (``hpfx_torch.solve.hpf_sweep``, layout "vmap") one,
with the device set scaled per scenario (:meth:`DeviceSet.scale`).

Sign conventions as in the reference: the mismatch adds +S for loads;
injections I_N − Y_N·V are added to the line currents Y·V; the Jacobian
normalizes by the signed magnitude (V/V_m = e^{j·theta}), and negative
magnitudes are cleaned up only after the loop.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import cx
from .config import Settings
from .cx import Cx
from .devices import AnalyticDeviceSet, DeviceSet, check_devices
from .fundamental import FundResult, _power_jacobian_blocks, solve_fundamental
from .network import Network
from .ops.batched_solve import nr_solve
from .parallel.mesh import ALONE
from .ybus import build_ybus, line_ybus_pair, resolve_ybus, stable_matvec


class HPFResult(NamedTuple):
    V_m: torch.Tensor          # (H, n) or batch-major (B, H, n), cleaned
    V_a: torch.Tensor          # angles in [0, 2pi)
    err: torch.Tensor
    n_iter: torch.Tensor
    err_hist: torch.Tensor     # (max_iter_h,) or (B, max_iter_h), NaN-padded
    converged: torch.Tensor
    fund: Optional[FundResult] = None
    #: optional per-iteration raw (V_m, V_a), (max_iter_h + 1, 2, H, n),
    #: NaN-padded past n_iter (``record_trajectory``)
    trajectory: Optional[torch.Tensor] = None


def current_injections(V_c: Cx, devices, m: int, V_m=None, V_a=None) -> Cx:
    """Current injections of every nonlinear bus, (..., n_nl, H): Norton
    I_N − Y_N·V, or an AnalyticDeviceSet's own function of the polar
    ``V_m``/``V_a``."""
    if isinstance(devices, AnalyticDeviceSet):
        return devices.injections(V_m[..., :, m:], V_a[..., :, m:])
    V_nl = V_c[..., :, m:]                              # (..., H, n_nl)
    if devices.coupled:
        return devices.I_N - cx.einsum("...dhp,...pd->...dh", devices.Y_N,
                                       V_nl)
    return devices.I_N - devices.Y_N * V_nl.mT


def _per_order(Y) -> str:
    """The einsum of one Y·V product per harmonic order: Y (H, n, n)
    shared by every scenario, or (..., H, n, n), one network per
    scenario."""
    return "hij,...hj->...hi" if Y.ndim == 3 else "...hij,...hj->...hi"


def current_balance(V_c: Cx, Y: Cx, devices, m: int, n: int,
                    V_m=None, V_a=None, YV: Optional[Cx] = None,
                    I_bg: Optional[Cx] = None) -> Cx:
    """Current balance: the fundamental at the nonlinear buses, then every
    bus at each harmonic above it, injections added at the nonlinear
    buses.  ``YV``: optional precomputed (..., H, n) Y·V (the stable
    mismatch).  ``I_bg``: optional constant (..., H, n) background
    injections (fundamental row zero), added on every bus's harmonic
    rows."""
    I_inj = current_injections(V_c, devices, m, V_m, V_a)  # (..., n_nl, H)
    if YV is None:
        dI_f = cx.matvec(Y[..., 0, m:, :], V_c[..., 0, :]) + I_inj[..., :, 0]
        dI_h = cx.einsum(_per_order(Y), Y[..., 1:, :, :], V_c[..., 1:, :])
    else:
        dI_f = YV[..., 0, m:] + I_inj[..., :, 0]
        dI_h = YV[..., 1:, :]
    dI_h = dI_h.at_add((..., slice(None), slice(m, None)),
                       I_inj[..., :, 1:].mT)
    if I_bg is not None:
        dI_h = dI_h + I_bg[..., 1:, :]
    return cx.concatenate([dI_f, Cx(dI_h.re.flatten(-2),
                                    dI_h.im.flatten(-2))], axis=-1)


def harmonic_mismatch(V_m, V_a, Y: Cx, S: Cx, devices,
                      m: int, n: int, c: int, lineY=None,
                      I_bg: Optional[Cx] = None):
    """Harmonic mismatch f = [Re f_c, Im f_c[c-1:]] with f_c = [dS (power,
    linear non-slack buses), dI (current balance)], and its max-abs err.
    ``lineY``: optional ``LineYbus``; every Y·V is then taken in the
    cancellation-free form.  ``I_bg``: as in :func:`current_balance`."""
    V_c = cx.polar(V_m, V_a)
    YV = None if lineY is None else stable_matvec(lineY, V_m, V_a)
    I1 = cx.matvec(Y[..., 0, 1:m, :], V_c[..., 0, :]) if YV is None \
        else YV[..., 0, 1:m]
    dS = S[..., 1:m] + V_c[..., 0, 1:m] * I1.conj()
    dI = current_balance(V_c, Y, devices, m, n, V_m, V_a, YV=YV, I_bg=I_bg)
    f_c = cx.concatenate([dS, dI], axis=-1)
    f = torch.cat([f_c.re, f_c.im[..., c - 1:]], dim=-1)
    return f, f.abs().amax(dim=-1)


def harmonic_state_vector(V_m, V_a, c: int):
    """x = [angles.flat[1:], magnitudes.flat[c:]] over the (harmonic, bus)
    row-major layout."""
    return torch.cat([V_a.flatten(-2)[..., 1:], V_m.flatten(-2)[..., c:]],
                     dim=-1)


def update_harmonic_voltages(V_m, V_a, x, H: int, n: int, c: int):
    """Write the state vector back into the (..., H, n) voltages, with no
    sign or angle cleanup (the reference cleans up after the loop only)."""
    D = H * n
    shape = V_m.shape
    V_a = torch.cat([V_a.flatten(-2)[..., :1], x[..., : D - 1]], dim=-1)
    V_m = torch.cat([V_m.flatten(-2)[..., :c], x[..., D - 1:]], dim=-1)
    return V_m.reshape(shape), V_a.reshape(shape)


def norton_coupling(V_m, V_a, devices, m: int):
    """K_V, K_A (..., H, H, n_nl): what the devices add to the Jacobian's
    (h·n+i, p·n+i) entries, i = m + d.  Norton: −Y_N[d,h,p]·Vn[p,i] and
    −j·Y_N[d,h,p]·V[p,i], an uncoupled device only at h == p; an
    AnalyticDeviceSet: dI_inj[d,h]/dV_m[p] and dI_inj[d,h]/dV_a[p] by
    forward-mode autodiff."""
    if isinstance(devices, AnalyticDeviceSet):
        JV, JA = devices.injection_jacobians(V_m[..., :, m:],
                                             V_a[..., :, m:])
        return (Cx(_device_last(JV.re), _device_last(JV.im)),
                Cx(_device_last(JA.re), _device_last(JA.im)))
    Vn_nl = cx.expj(V_a)[..., :, m:]                    # (..., H, n_nl)
    V_nl = cx.polar(V_m, V_a)[..., :, m:]
    if devices.coupled:
        K_V = -cx.einsum("...dhp,...pd->...hpd", devices.Y_N, Vn_nl)
        K_A = -cx.einsum("...dhp,...pd->...hpd", devices.Y_N, V_nl).jmul()
        return K_V, K_A
    H = V_m.shape[-2]
    eye = torch.eye(H, dtype=V_m.dtype, device=V_m.device)[:, :, None]
    diag = lambda z: Cx(eye * z.re[..., :, None, :], eye * z.im[..., :, None, :])
    Yt = devices.Y_N.mT                                 # (..., H, n_nl)
    return diag(-(Yt * Vn_nl)), diag(-(Yt * V_nl).jmul())


def _device_last(J):
    """(..., n_nl, H, H) -> (..., H, H, n_nl)."""
    return J.movedim(-3, -1)


class _JacobianMap(NamedTuple):
    """Where the harmonic Jacobian's pieces land in the dense (dim, dim)
    matrix, flattened: ``copies`` holds (piece, part, source indices,
    matrix indices) for the pieces written once, ``adds`` (piece, part,
    matrix indices) for the Norton coupling, added over them.
    ``row_harmonic`` (dim,) is the harmonic each row belongs to (the
    power rows to 0)."""
    dim: int
    copies: tuple
    adds: tuple
    row_harmonic: np.ndarray


@functools.lru_cache(maxsize=16)
def _jacobian_map(H: int, n: int, m: int, c: int,
                  device: torch.device) -> _JacobianMap:
    """The dense layout of the reference: rows [P (buses 1..m-1), Re I
    (flat k >= m), Q (buses c..m-1), Im I (flat k >= m)], columns
    [angles (flat l >= 1), magnitudes (flat l >= c)].  Pieces: "A" and
    "V" the (H, n, n) diagonal blocks, "KA" and "KV" the (H, H, n_nl)
    coupling, "SA" and "SV" the (n, n) fundamental power blocks."""
    D = H * n
    dim = 2 * D - 1 - c
    row_re = lambda k: (m - 1) + (k - m)
    row_im = lambda k: (m - 1) + (D - m) + (m - c) + (k - m)
    col = {"A": lambda l: l - 1, "V": lambda l: (D - 1) + (l - c)}
    first = {"A": 1, "V": c}
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    copies, adds = [], []
    h, i, j = (a.ravel() for a in np.meshgrid(
        np.arange(H), np.arange(n), np.arange(n), indexing="ij"))
    k, l = h * n + i, h * n + j
    h, p, d = (a.ravel() for a in np.meshgrid(
        np.arange(H), np.arange(H), np.arange(n - m), indexing="ij"))
    kc, lc = h * n + m + d, p * n + m + d
    i, j = (a.ravel() for a in np.meshgrid(np.arange(n), np.arange(n),
                                           indexing="ij"))
    for w in ("A", "V"):
        sel = np.nonzero((k >= m) & (l >= first[w]))[0]
        for part, row in (("re", row_re), ("im", row_im)):
            copies.append((w, part, t(sel),
                           t(row(k[sel]) * dim + col[w](l[sel]))))
            adds.append(("K" + w, part, t(row(kc) * dim + col[w](lc))))
        # the power rows: P (Re) of buses 1..m-1, Q (Im) of buses c..m-1
        for part, lo, row in (("re", 1, lambda r: r - 1),
                              ("im", c, lambda r: (m - 1) + (D - m) + (r - c))):
            sel = np.nonzero((i >= lo) & (i < m) & (j >= first[w]))[0]
            copies.append(("S" + w, part, t(sel),
                           t(row(i[sel]) * dim + col[w](j[sel]))))
    rows_h = np.zeros(dim, np.int64)
    k = np.arange(m, D)
    rows_h[row_re(k)] = rows_h[row_im(k)] = k // n
    return _JacobianMap(dim=dim, copies=tuple(copies), adds=tuple(adds),
                        row_harmonic=rows_h)


@functools.lru_cache(maxsize=64)
def _jacobian_rows_map(H: int, n: int, m: int, c: int, device: torch.device,
                       h0: int, h1: int):
    """The writes of :func:`_jacobian_map` into the rows of harmonics
    [h0, h1), and where those rows sit: ``rows`` (h1 - h0, 2n) indexes
    the dense matrix with one zero row appended (index dim), harmonic 0's
    d0 rows padded with it to 2n; ``order`` (dim,) takes each dense row
    from the (H·2n) rows of every harmonic, so laid out."""
    mp = _jacobian_map(H, n, m, c, device)
    dim, rh = mp.dim, mp.row_harmonic
    def mine(dst):
        h = rh[dst.cpu().numpy() // dim]
        return torch.as_tensor(np.nonzero((h >= h0) & (h < h1))[0],
                               device=device)

    copies = tuple((w, p, src[sel], dst[sel]) for w, p, src, dst in mp.copies
                   for sel in (mine(dst),))
    adds = tuple((w, p, sel, dst[sel]) for w, p, dst in mp.adds
                 for sel in (mine(dst),))
    rows = np.full((H, 2 * n), dim, np.int64)
    for h in range(H):
        own = np.nonzero(rh == h)[0]
        rows[h, :own.size] = own
    order = np.empty(dim, np.int64)
    order[rows[rows < dim]] = np.nonzero((rows < dim).ravel())[0]
    t = lambda a: torch.as_tensor(a, device=device)
    return copies, adds, t(rows[h0:h1]), t(order)


def build_harmonic_jacobian(V_m, V_a, Y: Cx, devices,
                            m: int, n: int, c: int, mesh=ALONE):
    """Dense real harmonic Jacobian (..., dim, dim), dim = 2·H·n − 1 − c
    (``hpfx.harmonic.build_harmonic_jacobian``, the same values):

    - diagonal blocks dI/dV|_hh = Y_h·diag(Vn_h), dI/dA|_hh = j·Y_h·diag(V_h);
    - Norton coupling added at the (h·n+i, p·n+i) entries of the nonlinear
      buses (:func:`norton_coupling`);
    - the fundamental power rows, zero across the harmonic columns, with
      the signed-magnitude normalization;

    cropped to the current-balance rows (flat k >= m) and the state
    columns (angles 1:, magnitudes c:).  Written entry by entry into a
    zero matrix (``index_copy_``/``index_add_`` on its flattened rows),
    where the JAX package broadcasts against masks.

    ``mesh``: a mesh whose harmonic group splits the rows: each rank
    writes the rows of its harmonics only, and the rows are all-gathered
    (2n a harmonic, harmonic 0's d0 padded), so that every rank returns
    the whole matrix."""
    H = V_m.shape[-2]
    batch = V_m.shape[:-2]
    mp = _jacobian_map(H, n, m, c, V_m.device)
    copies, adds = mp.copies, mp.adds
    if mesh.hgroup is not None:
        h0, h1 = mesh.hbounds(H)
        copies, adds, rows, order = _jacobian_rows_map(H, n, m, c,
                                                       V_m.device, h0, h1)
    V_c = cx.polar(V_m, V_a)
    Vn = cx.expj(V_a)
    row = lambda z: Cx(z.re[..., :, None, :], z.im[..., :, None, :])
    K_V, K_A = norton_coupling(V_m, V_a, devices, m)
    dSdA, dSdV = _power_jacobian_blocks(V_c[..., 0, :], Vn[..., 0, :],
                                        Y[..., 0, :, :], n)
    pieces = {"A": (Y * row(V_c)).jmul(), "V": Y * row(Vn),
              "KA": K_A, "KV": K_V, "SA": dSdA, "SV": dSdV}
    part = lambda w, p: getattr(pieces[w], p).flatten(-3 if w[0] != "S"
                                                      else -2)
    J = torch.zeros(batch + (mp.dim * mp.dim,), dtype=V_m.dtype,
                    device=V_m.device)
    for w, p, src, dst in copies:
        J.index_copy_(-1, dst, part(w, p)[..., src])
    if mesh.hgroup is None:
        for w, p, dst in adds:
            J.index_add_(-1, dst, part(w, p))
        return J.reshape(batch + (mp.dim, mp.dim))
    for w, p, sel, dst in adds:
        J.index_add_(-1, dst, part(w, p)[..., sel])
    J = J.reshape(batch + (mp.dim, mp.dim))
    J = torch.cat([J, J.new_zeros(batch + (1, mp.dim))], dim=-2)
    mine = J[..., rows.flatten(), :].unflatten(-2, tuple(rows.shape))
    every = mesh.hgather(mine, H, -3)                   # (..., H, 2n, dim)
    return every.flatten(-3, -2)[..., order, :]


def mismatch_floor(V_m, Y: Cx, devices, m: int, settings: Settings,
                   I_bg: Optional[Cx] = None):
    """Evaluation floor of the harmonic mismatch, eps·scale, with scale the
    largest row sensitivity: max over (h, i) of sum_j |Y[h,i,j]|·|V_j|,
    of sum_p |Y_N[·,h,p]|·|V_p| on the nonlinear rows of Norton devices,
    and of the background injections |I_bg|."""
    eps = torch.finfo(settings.real_dtype).eps
    vmax = V_m.abs()                                    # (..., H, n)
    scale = torch.einsum(_per_order(Y), Y.abs(), vmax).amax(dim=(-2, -1))
    if isinstance(devices, DeviceSet) and devices.n_devices > 0:
        v_nl = vmax[..., :, m:]                         # (..., H, n_nl)
        if devices.coupled:
            inj = torch.einsum("...dhp,...pd->...dh", devices.Y_N.abs(), v_nl)
        else:
            inj = devices.Y_N.abs() * v_nl.mT
        scale = torch.maximum(scale, inj.amax(dim=(-2, -1)))
    if I_bg is not None:
        scale = torch.maximum(scale, I_bg.abs().amax(dim=(-2, -1)))
    return eps * scale


def lifted_threshold(thresh, settings: Settings):
    """Where the floor lifted a finite threshold above ``thresh_h``.
    There the mismatch alone does not tell the trip before Newton's
    float32 plateau from the plateau, whose mismatch can read as high,
    and the stop also tests the trip's phasor step
    (:func:`long_step_err`)."""
    return (thresh > settings.thresh_h) & torch.isfinite(thresh)


def long_step_err(err, thresh, lifted, V_m, V_a, Vm_new, Va_new, dims,
                  step_stop: float):
    """``err`` of a trip's new state, raised past ``thresh`` where the
    threshold is ``lifted``, the mismatch meets it and the trip moved a
    phasor by more than ``step_stop`` (pu, ``Settings.step_stop``): to
    ``thresh`` times the step over ``step_stop``, so that the lane takes
    another trip.  ``dims``: the harmonic and bus axes of the voltages."""
    step = (cx.polar(Vm_new, Va_new) - cx.polar(V_m, V_a)).abs().amax(
        dim=dims)
    long = lifted & (err <= thresh) & (step > step_stop)
    return torch.where(long, thresh * (step / step_stop), err)


def init_harmonic_voltages(fund: FundResult, net: Network,
                           settings: Settings):
    """Flat-start harmonic voltages with the fundamental solution in row 0,
    one (H, n) spectrum per scenario of ``fund``."""
    H, rd = settings.n_harmonics, settings.real_dtype
    shape = fund.V_m.shape[:-1] + (H, net.n)
    V_m = torch.full(shape, settings.v_init_h, dtype=rd, device=net.device)
    V_a = torch.full(shape, settings.a_init_h, dtype=rd, device=net.device)
    V_m[..., 0, :] = fund.V_m
    V_a[..., 0, :] = fund.V_a
    return V_m, V_a


def cleanup_voltages(V_m, V_a):
    """Post-loop sign/angle normalization (hcne_generalized.py:546-549):
    add pi to angles of negative magnitudes, wrap angles to [0, 2pi), flip
    magnitude signs."""
    neg = V_m < 0
    V_a = torch.remainder(torch.where(neg, V_a + math.pi, V_a), 2 * math.pi)
    return torch.where(neg, -V_m, V_m), V_a


def solve_harmonic(Y: Cx, fund: FundResult, net: Network,
                   devices, settings: Settings, V0=None,
                   record_trajectory: bool = False, lineY=None,
                   I_bg=None, mesh=ALONE) -> HPFResult:
    """The harmonic Newton loop (``hpfx.harmonic.solve_harmonic``).

    ``V0``: optional (V_m, V_a) start in place of the flat start; the
    floor-aware threshold, max(thresh_h, floor_kappa·mismatch_floor), is
    taken at the cold flat start either way; where the floor lifts it
    above ``thresh_h``, a scenario stops only after a trip that moved no
    phasor by more than ``settings.step_stop`` (:func:`long_step_err`).
    ``record_trajectory`` keeps the raw (V_m, V_a) of every iteration.
    ``devices``: a Norton DeviceSet or an AnalyticDeviceSet; anything
    else raises ``TypeError``.  ``I_bg``: optional constant (..., H, n)
    background injections (``hpfx_torch.background``; fundamental row
    zero): they enter the mismatch and the floor, not the Jacobian.
    ``settings.solver`` picks the Newton step: "dense" solves the dense
    Jacobian (:func:`nr_solve`), "arrow" its block and Woodbury structure
    (``hpfx_torch.arrow``).

    Leading scenario axes (of ``fund``, the network's loads and the scaled
    device set) are solved as one batch, as the JAX package's ``vmap``
    solves them: the body runs over the whole batch and a scenario's state
    stops changing once its own test fails (``torch.where`` on its active
    flag, never a gather of the active scenarios, which would change the
    batch the solves see and so their rounding); the loop ends when none
    is active, with one host synchronisation per iteration.

    ``mesh``: a mesh whose harmonic group splits each Newton step
    (:func:`hpfx_torch.parallel.hpf_single_hsharded`; JAX's
    ``vsharding``): the arrow blocks and their solves, or the dense
    Jacobian's rows, by harmonic, all-gathered; the mismatch, the
    capacitance system and the dense solve whole on every rank, so that
    every rank holds the same state and takes the same loop decisions."""
    check_devices(devices)
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    rd, dv = settings.real_dtype, net.device
    S = Cx(net.bus_P, net.bus_Q)

    cold_V_m, cold_V_a = init_harmonic_voltages(fund, net, settings)
    V_m, V_a = (cold_V_m, cold_V_a) if V0 is None else V0
    batch = cold_V_m.shape[:-2]
    f, err = harmonic_mismatch(V_m, V_a, Y, S, devices, m, n, c, lineY,
                               I_bg=I_bg)
    thresh = torch.clamp_min(
        settings.floor_kappa
        * mismatch_floor(cold_V_m, Y, devices, m, settings, I_bg=I_bg),
        settings.thresh_h)
    x = harmonic_state_vector(V_m, V_a, c)
    hist = torch.full(batch + (settings.max_iter_h,), float("nan"),
                      dtype=rd, device=dv)
    traj = None
    if record_trajectory:
        traj = torch.full(batch + (settings.max_iter_h + 1, 2, H, n),
                          float("nan"), dtype=rd, device=dv)
        traj[..., 0, :, :, :] = torch.stack([V_m, V_a], dim=-3)

    if settings.solver == "arrow":
        from .arrow import arrow_solve, build_arrow_pieces, make_arrow_index
        arrow_idx = make_arrow_index(H, n, m, c)

    def newton_step(V_m, V_a, f):
        if settings.solver == "arrow":
            pieces = build_arrow_pieces(V_m, V_a, Y, devices, arrow_idx,
                                        mesh=mesh)
            return arrow_solve(pieces, f, arrow_idx, mesh=mesh)
        return nr_solve(build_harmonic_jacobian(V_m, V_a, Y, devices, m, n, c,
                                                mesh=mesh), f)

    it = torch.zeros(batch, dtype=torch.int32, device=dv)
    t = 0
    # a lifted lane stops only after a short trip, so it takes one from
    # wherever it starts
    lifted = lifted_threshold(thresh, settings)
    act = ((err > thresh) | lifted) & (it < settings.max_iter_h)
    while bool(act.any()):
        x_new = x - newton_step(V_m, V_a, f)
        Vm_new, Va_new = update_harmonic_voltages(V_m, V_a, x_new, H, n, c)
        f_new, err_new = harmonic_mismatch(Vm_new, Va_new, Y, S, devices,
                                           m, n, c, lineY, I_bg=I_bg)
        err_new = long_step_err(err_new, thresh, lifted, V_m, V_a, Vm_new,
                                Va_new, (-2, -1), settings.step_stop)
        a1, a2 = act[..., None], act[..., None, None]
        V_m = torch.where(a2, Vm_new, V_m)
        V_a = torch.where(a2, Va_new, V_a)
        x = torch.where(a1, x_new, x)
        f = torch.where(a1, f_new, f)
        err = torch.where(act, err_new, err)
        hist[..., t] = torch.where(act, err_new, hist[..., t])
        if traj is not None:
            traj[..., t + 1, :, :, :] = torch.where(
                act[..., None, None, None], torch.stack([V_m, V_a], dim=-3),
                traj[..., t + 1, :, :, :])
        it = it + act.to(torch.int32)
        t += 1
        act = (err > thresh) & (it < settings.max_iter_h)

    V_m, V_a = cleanup_voltages(V_m, V_a)
    return HPFResult(V_m, V_a, err, it, hist, err <= thresh, fund, traj)


def hpf(net: Network, devices, settings: Settings, Y=None,
        V0=None, record_trajectory: bool = False, I_bg=None,
        Y_diag: Optional[Cx] = None) -> HPFResult:
    """Full harmonic power flow (``hpfx.harmonic.hpf``): admittances, the
    fundamental Newton solve, then the harmonic one.

    ``Y``: a dense ``Cx`` override (the stable mismatch is then off) or a
    ``(Y, lineY, lineY_f)`` triple that carries its own structures.
    ``Y_diag``: optional (H, n) per-bus shunt admittances folded into the
    built admittances and the line structure's diagonal (ignored with a
    ``Y`` override).  ``V0``: optional (V_m, V_a) start.  ``I_bg``:
    optional (H, n) background injections (:func:`solve_harmonic`)."""
    check_devices(devices)
    if Y is None:
        Y = build_ybus(net, settings)
        lineY, lineY_f = line_ybus_pair(net, settings)
        if Y_diag is not None:
            from .ybus import fold_ydiag
            Y = fold_ydiag(Y, Y_diag)
            if lineY is not None:
                lineY = lineY._replace(d=lineY.d + Y_diag)
                lineY_f = lineY_f._replace(d=lineY_f.d + Y_diag[:1])
    else:
        Y, lineY, lineY_f = resolve_ybus(net, settings, Y)
    fund = solve_fundamental(Y[..., 0, :, :], net, settings, lineY=lineY_f)
    return solve_harmonic(Y, fund, net, devices, settings, V0=V0,
                          record_trajectory=record_trajectory, lineY=lineY,
                          I_bg=I_bg)
