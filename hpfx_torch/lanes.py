"""Lane-major batched harmonic power flow: the port of :mod:`hpfx.lanes`.

Every tensor of the batched Newton trip carries the scenario batch on its
LAST axis: voltages (H, n, B), Jacobian blocks (H, 2n, 2n, B), residuals
(dim, B).  The solves of the trip take those lane-major operands as they
are (``hpfx_torch.ops.batched_solve``).  The math is that of the JAX
module, function for function, with the same names, so intermediates
compare one to one.

Scope: the structured arrow Newton step (``Settings.solver = "arrow"``)
with stacked Norton-equivalent devices (:class:`DeviceSet`, coupled or
uncoupled), device mixes (a :class:`DeviceLibrary` blended per scenario
by ``Scenarios.device_mix``, :class:`LaneDevices` with a trailing lane
axis) and autodiff devices (:class:`AnalyticDeviceSet`, vectorized over
the lanes by ``torch.func.vmap``); plain or stable mismatch, PV buses,
per-device injection scales, warm starts, a ``Y`` override and
per-scenario background injections ``I_bg``.  ``lax.while_loop``
becomes a Python ``while`` on ``bool(active.any())``: one device-to-host
synchronisation per Newton trip.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import cx
from .arrow import _ArrowConsts, _consts
from .config import Settings
from .cx import Cx
from .devices import AnalyticDeviceSet, DeviceLibrary, DeviceSet
from .fundamental import FundResult
from .harmonic import (HPFResult, cleanup_voltages, lifted_threshold,
                       long_step_err)
from .network import Network
from .ops.batched_solve import batched_solve_lanes
from .parallel.mesh import ALONE
from .utils.profiling import (PhaseLog, _clock, _harmonic_trip, _phase,
                              _read, _trip)
from .utils.profiling import span as _span
from .warmstart import _floor_seed_mag
from .ybus import LineYbus, _polar_diff, incidence, resolve_ybus

#: memory budget for the warm-seed embedded matrix (2N, 2N, chunk): the
#: seed assembly and solve chunk the lane axis to stay under it
SEED_CHUNK_BYTES = 1 << 31

_all = slice(None)


class LaneDevices(NamedTuple):
    """Norton parameters in the lane layout (``hpfx.lanes.LaneDevices``).

    ``batched=False``: a DeviceSet's arrays, I_N (n_nl, H) and Y_N
    (n_nl, H, H) or (n_nl, H), shared by every lane.  ``batched=True``:
    per-lane arrays with a trailing lane axis, I_N (n_nl, H, B) and Y_N
    (n_nl, H, H, B) or (n_nl, H, B), blended once per sweep from a
    DeviceLibrary and the lanes' device mixes."""
    I_N: Cx
    Y_N: Cx
    coupled: bool
    batched: bool


def _as_lane_devices(devices):
    if isinstance(devices, (LaneDevices, AnalyticDeviceSet)):
        return devices
    return LaneDevices(devices.I_N, devices.Y_N, devices.coupled, False)


def _mix_lane_devices(lib: DeviceLibrary, mix, rd) -> LaneDevices:
    """Blend a DeviceLibrary with (B, n_nl, T) weights into lane-major
    device arrays: I_N[d, h, b] = sum_t mix[b, d, t]·I_lib[t, h] (Y_N the
    same)."""
    w = mix.to(rd)
    es = lambda spec, arr: Cx(torch.einsum(spec, w, arr.re),
                              torch.einsum(spec, w, arr.im))
    return LaneDevices(
        I_N=es("bdt,th->dhb", lib.I_lib),
        Y_N=es("bdt,thp->dhpb" if lib.coupled else "bdt,th->dhb", lib.Y_lib),
        coupled=lib.coupled, batched=True)


def _lane(a, batched: bool):
    """A device array with a trailing lane axis: its own when batched (a
    device mix), of size 1 when every lane shares it."""
    return a if batched else a[..., None]


def _device_matvec(Y_N: Cx, V_nl: Cx) -> Cx:
    """sum_p Y_N[d, h, p, b]·V[p, d, b] -> (n_nl, H, B), with Y_N
    (n_nl, H, H, B|1) and V_nl (H, n_nl, B): one elementwise product and
    one sum over p, whether the lanes share the devices or not, so that a
    one-hot device mix of a DeviceSet's types takes the DeviceSet's
    arithmetic, bit for bit."""
    V = V_nl.transpose(1, 0, 2)[:, None]                 # (n_nl, 1, H, B)
    # the products' layout follows their operands' strides; summing a
    # contiguous copy fixes the order of the sum
    total = lambda x: x.contiguous().sum(2)
    return Cx(total(Y_N.re * V.re - Y_N.im * V.im),
              total(Y_N.re * V.im + Y_N.im * V.re))


def _lanes_first(fn, *lanes_last):
    """Call a batch-first function on lane-last tensors and move the lane
    axis of its Cx results back to the end."""
    out = fn(*(x.movedim(-1, 0) for x in lanes_last))
    back = lambda z: Cx(z.re.movedim(0, -1), z.im.movedim(0, -1))
    return back(out) if isinstance(out, Cx) else tuple(map(back, out))


def _as_inj_db(inj, n_nl: int, B: int):
    """Injection scale as device-major (n_nl, B): a (B,) per-scenario
    scale broadcasts over devices; 2-D input is already (n_nl, B)."""
    if inj.ndim == 1:
        return inj[None, :].expand(n_nl, B)
    return inj


# ---------------------------------------------------------------------------
# mismatch (lane-major)
# ---------------------------------------------------------------------------

def stable_matvec_lanes(lineY: LineYbus, V_m, V_a) -> Cx:
    """Cancellation-free Y·V on (H, n, B) polar voltages
    (``hpfx.lanes.stable_matvec_lanes``): per-line flows, each difference
    taken in polar form, summed into buses by a one-hot incidence
    contraction."""
    f, t = lineY.f_idx, lineY.t_idx
    a_ff = lineY.a_ff[:, None]                  # (L, 1)
    inv_tau = lineY.inv_tau[:, None]
    shift = lineY.shift[:, None]
    flow_f = lineY.Ys[..., None] * _polar_diff(
        V_m[:, f] * a_ff, V_a[:, f], V_m[:, t] * inv_tau, V_a[:, t] + shift)
    flow_t = lineY.Ys[..., None] * _polar_diff(
        V_m[:, t], V_a[:, t], V_m[:, f] * inv_tau, V_a[:, f] - shift)
    out = lineY.d[..., None] * cx.polar(V_m, V_a)
    Minc = incidence(f, t, V_m.shape[1], V_m.dtype)    # (n, 2L)
    flows = cx.concatenate([flow_f, flow_t], axis=1)   # (H, 2L, B)
    acc = lambda x: torch.einsum("nl,hlb->hnb", Minc, x)
    return out + Cx(acc(flows.re), acc(flows.im))


def _injections_lanes(V_c: Cx, dev, inj_db, m: int, V_m=None,
                      V_a=None, hs=_all) -> Cx:
    """Current injections on (H, n, B) voltages -> (n_nl, H, B), scaled
    per device by ``inj_db`` (n_nl, B): Norton I_N − Y_N·V (``dev`` a
    LaneDevices), or an AnalyticDeviceSet's function of the polar
    ``V_m``/``V_a``, vectorized over the lanes.  ``hs``: a slice of the
    harmonics to return (each from the voltages of every harmonic)."""
    if isinstance(dev, AnalyticDeviceSet):
        raw = _lanes_first(dev.injections, V_m[:, m:], V_a[:, m:])[:, hs]
        return raw * inj_db[:, None, :]
    V_nl = V_c[:, m:]                                    # (H, n_nl, B)
    lane = lambda z: Cx(_lane(z.re, dev.batched)[:, hs],
                        _lane(z.im, dev.batched)[:, hs])
    if dev.coupled:
        raw = lane(dev.I_N) - _device_matvec(lane(dev.Y_N), V_nl)
    else:
        raw = lane(dev.I_N) - lane(dev.Y_N) * V_nl.transpose(1, 0, 2)[:, hs]
    return raw * inj_db[:, None, :]


def mismatch_lanes(V_m, V_a, Y: Cx, S: Cx, devices, inj,
                   m: int, n: int, c: int, lineY: Optional[LineYbus],
                   ibg: Optional[Cx] = None, mesh=ALONE):
    """Harmonic mismatch on (H, n, B) voltages; S is the scaled (n, B)
    load, ``devices`` a DeviceSet, LaneDevices or AnalyticDeviceSet,
    ``inj`` a (B,) or (n_nl, B) injection scale, ``ibg`` optional (H, n,
    B) background injections (fundamental row zero) added to the harmonic
    rows.  ``mesh``: a mesh whose harmonic group splits the Y·V rows and
    the Norton injections by harmonic and all-gathers them, so that every
    rank of the group assembles the same ``f``.  Returns (f (rows, B), err
    (B,))."""
    dev = _as_lane_devices(devices)
    inj_db = _as_inj_db(inj, n - m, V_m.shape[-1])
    H = V_m.shape[0]
    h0, h1 = mesh.hbounds(H)
    hs = slice(h0, h1)
    V_c = cx.polar(V_m, V_a)
    if lineY is None:
        YV = cx.einsum("hij,hjb->hib", Y[hs], V_c[hs])
    else:
        YV = stable_matvec_lanes(lineY._replace(Ys=lineY.Ys[hs],
                                                d=lineY.d[hs]),
                                 V_m[hs], V_a[hs])
    I_inj = _injections_lanes(V_c, dev, inj_db, m, V_m, V_a, hs)
    if mesh.hgroup is not None:
        k = n - m
        rows = torch.cat([YV.re, YV.im, I_inj.re.transpose(0, 1),
                          I_inj.im.transpose(0, 1)], dim=1)
        rows = mesh.hgather(rows, H, 0)            # (H, 2n + 2n_nl, B)
        YV = Cx(rows[:, :n], rows[:, n:2 * n])
        I_inj = Cx(rows[:, 2 * n:2 * n + k].transpose(0, 1),
                   rows[:, 2 * n + k:].transpose(0, 1))
    I1 = YV[0, 1:m]
    dS = S[1:m] + V_c[0, 1:m] * I1.conj()               # (m-1, B)
    dI_f = YV[0, m:] + I_inj[:, 0]
    dI_h = YV[1:].at_add((_all, slice(m, None)),
                         I_inj[:, 1:].transpose(1, 0, 2))  # (K, n, B)
    if ibg is not None:
        dI_h = dI_h + ibg[1:]
    K_, B = dI_h.shape[0], dI_h.shape[2]
    dI = cx.concatenate([dI_f, dI_h.reshape(K_ * n, B)])
    f_c = cx.concatenate([dS, dI])
    f = torch.cat([f_c.re, f_c[c - 1:].im], dim=0)
    return f, f.abs().amax(dim=0)


def mismatch_floor_lanes(V_m, Y: Cx, devices, inj, m: int,
                         settings: Settings, ibg: Optional[Cx] = None):
    """Per-scenario mismatch evaluation floor eps·scale -> (B,)
    (``hpfx.harmonic.mismatch_floor``); ``devices``/``inj``/``ibg`` as in
    :func:`mismatch_lanes`.  Analytic devices add no Norton sensitivity
    bound."""
    dev = _as_lane_devices(devices)
    inj_db = _as_inj_db(inj, V_m.shape[1] - m, V_m.shape[-1])
    eps = torch.finfo(settings.real_dtype).eps
    vmax = V_m.abs()                                      # (H, n, B)
    scale = torch.einsum("hij,hjb->hib", Y.abs(), vmax).amax(dim=(0, 1))
    if ibg is not None:
        scale = torch.maximum(scale, ibg.abs().amax(dim=(0, 1)))
    if isinstance(dev, AnalyticDeviceSet):
        return eps * scale
    if dev.I_N.shape[0] > 0:
        v_dl = vmax[:, m:].permute(1, 0, 2)               # (n_nl, H, B)
        Ya = _lane(dev.Y_N.abs(), dev.batched)
        if dev.coupled:   # as _device_matvec sums, for the same reason
            d_inj = (Ya * v_dl[:, None]).contiguous().sum(2)
        else:
            d_inj = Ya * v_dl
        scale = torch.maximum(
            scale, (d_inj * inj_db.abs()[:, None, :]).amax(dim=(0, 1)))
    return eps * scale


def _thresh_lanes(V_m, Y, dev, inj_db, m, settings, ibg=None):
    """Floor-aware convergence threshold max(thresh_h, kappa·floor)."""
    floor = mismatch_floor_lanes(V_m, Y, dev, inj_db, m, settings, ibg=ibg)
    return torch.clamp_min(settings.floor_kappa * floor, settings.thresh_h)


# ---------------------------------------------------------------------------
# arrow Newton step (lane-major)
# ---------------------------------------------------------------------------

def _power_jacobian_blocks_lanes(V: Cx, Vn: Cx, Y: Cx, n: int):
    """dS/dA and dS/dV (n, n, B) of the power rows on (n, B) voltages
    (``hpfx.fundamental._power_jacobian_blocks``)."""
    I = cx.einsum("ij,jb->ib", Y, V)
    eye = torch.eye(n, dtype=V.dtype, device=V.device)[:, :, None]
    diag_I = Cx(eye * I.re[:, None, :], eye * I.im[:, None, :])
    dSdA = (V[:, None] * (diag_I - Y[..., None] * V[None, :]).conj()).jmul()
    w = Vn * I.conj()
    diag_w = Cx(eye * w.re[:, None, :], eye * w.im[:, None, :])
    dSdV = diag_w + V[:, None] * (Y[..., None] * Vn[None, :]).conj()
    return dSdA, dSdV


def _coupling_lanes(V_m, V_a, dev, inj_db, m: int):
    """K_V/K_A (H, H, n_nl, B): the coupling of harmonic p into harmonic h
    at every nonlinear bus, scaled per device; for an AnalyticDeviceSet
    the autodiff blocks, vectorized over the lanes."""
    s = inj_db[None, None, :, :]
    if isinstance(dev, AnalyticDeviceSet):
        JV, JA = _lanes_first(dev.injection_jacobians, V_m[:, m:],
                              V_a[:, m:])                 # (n_nl, H, H, B)
        return JV.transpose(1, 2, 0, 3) * s, JA.transpose(1, 2, 0, 3) * s
    Vn_nl = cx.expj(V_a)[:, m:]                           # (H, n_nl, B)
    V_nl = cx.polar(V_m, V_a)[:, m:]
    if dev.coupled:
        spec = "dhpb,pdb->hpdb" if dev.batched else "dhp,pdb->hpdb"
        K_V = -cx.einsum(spec, dev.Y_N, Vn_nl)
        K_A = -cx.einsum(spec, dev.Y_N, V_nl).jmul()
    else:
        H, n_nl, B = Vn_nl.shape
        Yt = dev.Y_N.transpose(1, 0, 2) if dev.batched \
            else dev.Y_N.T[..., None]                     # (H, n_nl, B|1)
        hh = torch.arange(H, device=V_m.device)
        z = cx.zeros((H, H, n_nl, B), V_m.dtype, V_m.device)
        K_V = z.at_set((hh, hh), -(Yt * Vn_nl))
        K_A = z.at_set((hh, hh), -(Yt * V_nl).jmul())
    return K_V * s, K_A * s


def solve_arrow_blocks_lanes(D, rhs):
    """The arrow step's block solves: (k, k, b) blocks, each harmonic's
    block of every lane, and their (k, R, b) right-hand sides -> (k, R,
    b).  Its own function, called through the module, so that a trace can
    tell it from :func:`solve_capacitance_lanes`."""
    return batched_solve_lanes(D, rhs)


def solve_capacitance_lanes(S_w, rhs, big_solve: str = "auto"):
    """The arrow step's capacitance solve: (r, r, b) systems and (r, b)
    right-hand sides -> (r, b), past the direct kernels by ``big_solve``
    (:func:`batched_solve_lanes`'s ``impl``)."""
    return batched_solve_lanes(S_w, rhs[:, None, :], impl=big_solve)[:, 0]


def _capacitance_system_lanes(K_V: Cx, K_A: Cx, Gblocks, Vz, lanes: slice):
    """The Woodbury capacitance system of the lanes ``lanes``: S_w = I +
    C·G (r, r, b) and rhs_w = C·V^T z (r, b), r = 2·H·n_nl, from K_V/K_A
    (H, H, n_nl, B), ``Gblocks`` (H, 2n_nl, 2n_nl, B) and ``Vz`` (r, B).

    C couples harmonic p into h != p at one nonlinear bus: its row (h, ρ,
    d) (ρ: Re, Im) meets its column (p, c, e) (c: angle, magnitude) only
    where e = d.  So (C·G)[(h, ρ, d), (p, t)] = Σ_c A[h, ρ, d, p, c]·
    G[p, (c, d), t]: two broadcast products, the lanes innermost, write
    S_w once, and no dense C exists.  rhs_w sums its 2H products one
    fused multiply-add at a time, from the last (p, c) to the first: any
    order rounds as well, and the CPU tests that follow net1's chaotic
    Newton transient against the JAX package keep, with this one, at
    least the margins the dense product left them."""
    H, _, n_nl, _ = K_V.re.shape
    r = 2 * H * n_nl
    off = ~torch.eye(H, dtype=torch.bool, device=Vz.device)[:, :, None, None]
    # A[h, ρ, d, p, c, b]: the h != p coupling terms
    A = torch.stack([torch.where(off, k[..., lanes], 0.0)
                     for k in (K_A.re, K_V.re, K_A.im, K_V.im)])
    A = A.unflatten(0, (2, 2)).permute(2, 0, 4, 3, 1, 5)
    b = A.shape[-1]
    # G[c, d, p, t, b]
    G = Gblocks[..., lanes].unflatten(1, (2, n_nl)).permute(1, 2, 0, 3, 4)
    S_w = Vz.new_empty((H, 2, n_nl, H, 2 * n_nl, b))
    torch.mul(A[..., 0, None, :], G[0], out=S_w)
    S_w.addcmul_(A[..., 1, None, :], G[1])
    S_w = S_w.view(r, r, b)
    S_w.diagonal(0, 0, 1).add_(1.0)
    V = Vz[:, lanes].view(H, 2, n_nl, b)
    rhs_w = A.new_zeros((H, 2, n_nl, b))
    for p in reversed(range(H)):
        for c in (1, 0):
            rhs_w.addcmul_(A[:, :, :, p, c], V[p, c])
    return S_w, rhs_w.view(r, b)


def arrow_step_lanes(V_m, V_a, f, Y: Cx, devices, inj,
                     consts: _ArrowConsts, big_solve: str = "auto",
                     mesh=ALONE):
    """One arrow Newton-step solve J dx = f on (H, n, B) state and
    (dim, B) mismatch -> dx (dim, B): per-harmonic block solves plus the
    Woodbury capacitance solve (``hpfx.lanes.arrow_step_lanes``).
    ``devices``/``inj`` as in :func:`mismatch_lanes`.

    ``mesh``: a mesh whose harmonic group splits the step.  Each rank
    builds and solves the blocks of its harmonics (the rank of harmonic 0
    the fundamental block), and V^T·z and G are all-gathered; each builds
    and solves the capacitance system of its share of the lanes, and y is
    all-gathered; each back-substitutes its harmonics, and x is
    all-gathered.  Every rank returns the same dx."""
    idx = consts.idx
    H, n, m, c, d0 = idx.H, idx.n, idx.m, idx.c, idx.d0
    n_nl = n - m
    K = H - 1
    r = 2 * H * n_nl
    r_blk = 2 * n_nl
    rd, dv = V_m.dtype, V_m.device
    B = V_m.shape[-1]
    dev = _as_lane_devices(devices)
    inj_db = _as_inj_db(inj, n_nl, B)
    # this rank's harmonics [h0, h1) (its first block harmonic s0 >= 1)
    # and lanes [l0, l1) of the capacitance system
    h0, h1 = mesh.hbounds(H)
    s0 = max(h0, 1)
    l0, l1 = mesh.hbounds(B)

    with _span("trip.blocks"):
        V_c = cx.polar(V_m, V_a)
        Vn = cx.expj(V_a)
        Yl = Y[h0:h1]
        blocks_V = Yl[..., None] * Vn[h0:h1, None, :, :]  # (Hl, n, n, B)
        blocks_A = (Yl[..., None] * V_c[h0:h1, None, :, :]).jmul()
        # (H, H, n_nl, B)
        K_V, K_A = _coupling_lanes(V_m, V_a, dev, inj_db, m)

        # fold the h == p coupling into the diagonal blocks
        hh = torch.arange(h0, h1, device=dv)
        eye_n = torch.eye(n, dtype=rd, device=dv)[None, :, :, None]

        def _diag_fold(blocks: Cx, diag: Cx) -> Cx:
            pad = torch.zeros((h1 - h0, m, B), dtype=rd, device=dv)
            full_re = torch.cat([pad, diag.re], dim=1)    # (Hl, n, B)
            full_im = torch.cat([pad, diag.im], dim=1)
            return Cx(blocks.re + eye_n * full_re[:, None, :, :],
                      blocks.im + eye_n * full_im[:, None, :, :])

        M_V = _diag_fold(blocks_V, K_V[hh, hh])
        M_A = _diag_fold(blocks_A, K_A[hh, hh])
        k2 = 2 * n
        Dh = torch.cat([
            torch.cat([M_A.re[s0 - h0:], M_V.re[s0 - h0:]], dim=2),
            torch.cat([M_A.im[s0 - h0:], M_V.im[s0 - h0:]], dim=2),
        ], dim=1)                                     # (h1-s0, 2n, 2n, B)

        # grouped RHS + Woodbury U columns through one multi-RHS solve
        fp = f[consts.inv_f_perm]                         # (dim, B)
        fh = fp[d0:].reshape(K, k2, B)[s0 - 1:h1 - 1]
        rhsh = torch.cat([fh[:, :, None, :],
                          consts.Eh[None, :, :, None].expand(
                              h1 - s0, k2, r_blk, B)],
                         dim=2)                           # (h1-s0, 2n, R, B)
        D_all, rhs_all = Dh, rhsh
        if h0 == 0:
            dS1dA1, dS1dV1 = _power_jacobian_blocks_lanes(V_c[0], Vn[0],
                                                          Y[0], n)
            hcat = lambda a, b: torch.cat([a, b], dim=1)
            D0 = torch.cat([
                hcat(dS1dA1.re[1:m, 1:], dS1dV1.re[1:m, c:]),
                hcat(M_A.re[0, m:, 1:], M_V.re[0, m:, c:]),
                hcat(dS1dA1.im[c:m, 1:], dS1dV1.im[c:m, c:]),
                hcat(M_A.im[0, m:, 1:], M_V.im[0, m:, c:]),
            ], dim=0)                                     # (d0, d0, B)
            # identity-pad the fundamental block to 2n: one uniform batched
            # solve
            D0p = torch.eye(k2, dtype=rd, device=dv)[:, :, None].repeat(
                1, 1, B)
            D0p[:d0, :d0] = D0
            f0 = fp[:d0]
            rhs0 = torch.cat([f0[:, None, :],
                              consts.E0[:, :, None].expand(d0, r_blk, B)],
                             dim=1)
            rhs0p = torch.zeros((k2, 1 + r_blk, B), dtype=rd, device=dv)
            rhs0p[:d0] = rhs0
            D_all = torch.cat([D0p[None], Dh], dim=0)     # (Hl, 2n, 2n, B)
            rhs_all = torch.cat([rhs0p[None], rhsh], dim=0)

    with _span("trip.block_solve"):
        # (Hl, 2n, 2n, B) -> (2n, 2n, Hl·B): the harmonic-block axis joins
        # the lane batch, so all blocks go through one solve
        R = 1 + r_blk
        Hl = h1 - h0
        sol_all = rhs_all
        if Hl > 0:
            D_flat = D_all.permute(1, 2, 0, 3).reshape(k2, k2, Hl * B)
            rhs_flat = rhs_all.permute(1, 2, 0, 3).reshape(k2, R, Hl * B)
            sol = solve_arrow_blocks_lanes(D_flat, rhs_flat)
            # (Hl, 2n, R, B)
            sol_all = sol.reshape(k2, R, Hl, B).permute(2, 0, 1, 3)

    with _span("trip.capacitance"):
        zh, Xh = sol_all[s0 - h0:, :, 0], sol_all[s0 - h0:, :, 1:]
        Vz = zh[:, consts.cplh]                           # (h1-s0, rb, B)
        Gblocks = Xh[:, consts.cplh, :]                   # (h1-s0, rb, rb, B)
        if h0 == 0:
            # (d0, B), (d0, rb, B)
            z0, X0 = sol_all[0, :d0, 0], sol_all[0, :d0, 1:]
            Vz = torch.cat([z0[consts.cpl0][None], Vz], dim=0)
            Gblocks = torch.cat([X0[consts.cpl0][None], Gblocks], dim=0)
        if mesh.hgroup is not None:
            zG = mesh.hgather(torch.cat([Vz, Gblocks.flatten(1, 2)], dim=1),
                              H)
            Vz = zG[:, :r_blk]
            Gblocks = zG[:, r_blk:].reshape(H, r_blk, r_blk, B)
        Vz = Vz.reshape(r, B)

        with _span("trip.assemble"):
            S_w, rhs_w = _capacitance_system_lanes(K_V, K_A, Gblocks, Vz,
                                                   slice(l0, l1))
        y = rhs_w
        if l1 > l0:
            y = solve_capacitance_lanes(S_w, rhs_w, big_solve)
        y = mesh.hgather(y, B, -1)

    with _span("trip.backsub"):
        # back-substitution of this rank's harmonics, the fundamental block
        # padded to 2n, gathered
        yb = y.reshape(H, r_blk, B)
        # (h1-s0, 2n, B)
        x = zh - torch.einsum("kdsb,ksb->kdb", Xh, yb[s0:h1])
        if h0 == 0:
            x0 = z0 - torch.einsum("dsb,sb->db", X0, yb[0])
            x = torch.cat([torch.cat([x0, x0.new_zeros((k2 - d0, B))])[None],
                           x], dim=0)
        x = mesh.hgather(x, H, 0)                         # (H, 2n, B)
        xp = torch.cat([x[0, :d0], x[1:].reshape(K * k2, B)], dim=0)
        return xp[consts.x_perm]


# ---------------------------------------------------------------------------
# fundamental NR (lane-major)
# ---------------------------------------------------------------------------

class FundLanes(NamedTuple):
    V_m: torch.Tensor       # (n, B)
    V_a: torch.Tensor       # (n, B)
    err: torch.Tensor       # (B,)
    n_iter: torch.Tensor    # (B,)
    err_hist: torch.Tensor  # (max_iter_f, B)
    converged: torch.Tensor


def _fund_mismatch_lanes(V_m, V_a, Y1: Cx, S: Cx, c: int,
                         lineY: Optional[LineYbus]):
    V = cx.polar(V_m, V_a)
    if lineY is None:
        I = cx.einsum("ij,jb->ib", Y1, V)
    else:
        I = stable_matvec_lanes(lineY, V_m[None], V_a[None])[0]
    mis = V * I.conj() + S
    f = torch.cat([mis.re[1:], mis.im[c:]], dim=0)
    return f, f.abs().amax(dim=0)


def _fund_jacobian_lanes(V_m, V_a, Y1: Cx, n: int, c: int):
    V = cx.polar(V_m, V_a)
    Vn = V * (1.0 / V.abs())
    dSdA, dSdV = _power_jacobian_blocks_lanes(V, Vn, Y1, n)
    top = torch.cat([dSdA.re[1:, 1:], dSdV.re[1:, c:]], dim=1)
    bot = torch.cat([dSdA.im[c:, 1:], dSdV.im[c:, c:]], dim=1)
    return torch.cat([top, bot], dim=0)


def solve_fundamental_lanes(Y1: Cx, S: Cx, net: Network, settings: Settings,
                            B: int, lineY: Optional[LineYbus],
                            log: Optional[PhaseLog] = None) -> FundLanes:
    """Fundamental NR with the batch lane-minor; S is the per-scenario
    scaled (n, B) load.  Each lane stops when its own test fires."""
    n, c = net.n, net.c
    rd, dv = settings.real_dtype, S.re.device
    V_m = torch.full((n, B), settings.v_init_f, dtype=rd, device=dv)
    V_a = torch.full((n, B), settings.a_init_f, dtype=rd, device=dv)
    x = torch.cat([V_a[1:], V_m[c:]], dim=0)
    f, err = _fund_mismatch_lanes(V_m, V_a, Y1, S, c, lineY)
    hist = torch.full((settings.max_iter_f, B), float("nan"), dtype=rd,
                      device=dv)

    eps = torch.finfo(rd).eps
    rows = V_m.abs() * torch.einsum("ij,jb->ib", Y1.abs(), V_m.abs())
    thresh_eff = torch.clamp_min(
        settings.floor_kappa * eps * (rows + S.abs()).amax(dim=0),
        settings.thresh_f)

    it = torch.zeros((B,), dtype=torch.int32, device=dv)
    t = 0
    act = (err > thresh_eff) & (it < settings.max_iter_f)
    go = _read(log, bool, act.any())
    while go:
        with _span("fund_trip"):
            _trip(log)
            J = _fund_jacobian_lanes(V_m, V_a, Y1, n, c)
            x_new = x - batched_solve_lanes(J, f[:, None, :])[:, 0]
            Va_new = torch.cat([V_a[:1], x_new[: n - 1]], dim=0)
            Vm_new = torch.cat([V_m[:c], x_new[n - 1:]], dim=0)
            f_new, err_new = _fund_mismatch_lanes(Vm_new, Va_new, Y1, S, c,
                                                  lineY)
            V_m = torch.where(act, Vm_new, V_m)
            V_a = torch.where(act, Va_new, V_a)
            x = torch.where(act, x_new, x)
            f = torch.where(act, f_new, f)
            err = torch.where(act, err_new, err)
            hist[t] = torch.where(act, err_new, hist[t])
            it = it + act.to(torch.int32)
            t += 1
            act = (err > thresh_eff) & (it < settings.max_iter_f)
            go = _read(log, bool, act.any())
    return FundLanes(V_m, V_a, err, it, hist, err <= thresh_eff)


# ---------------------------------------------------------------------------
# the harmonic sweep
# ---------------------------------------------------------------------------

def supports_lanes(devices, settings: Settings, net: Network) -> bool:
    """Whether the lane-major path implements this configuration."""
    if settings.solver != "arrow" or net.n <= net.m:
        return False
    if isinstance(devices, (DeviceLibrary, AnalyticDeviceSet)):
        return True
    return isinstance(devices, DeviceSet) and devices.n_devices > 0


def _scale_cols(base, scale):
    """Per-scenario load scaling -> (n, B): scale is (B,) or (B, n)."""
    s = scale.to(base.dtype)
    if s.ndim == 1:
        return base[:, None] * s[None, :]
    return base[:, None] * s.T


def nr_trip_lanes(Y: Cx, lineY, S: Cx, dev, inj_db, V_m, V_a,
                  settings: Settings, consts: _ArrowConsts, thresh_eff,
                  f0=None, ibg: Optional[Cx] = None,
                  log: Optional[PhaseLog] = None, mesh=ALONE):
    """The lane-major harmonic NR loop from state (V_m, V_a) (H, n, B) to
    convergence or ``max_iter_h``.  ``f0``: optional precomputed (f, err)
    at the initial state; ``ibg``: optional (H, n, B) background
    injections.  ``mesh``: a mesh whose harmonic group splits each trip
    (:func:`mismatch_lanes`, :func:`arrow_step_lanes`); every rank of the
    group holds the same state, so each takes the same loop decisions.
    A lane stops where ``err`` meets ``thresh_eff``; where the floor lifted
    that above ``thresh_h``, ``err`` reads past it after a trip longer
    than ``settings.step_stop``
    (:func:`hpfx_torch.harmonic.long_step_err`).  Returns raw (V_m, V_a,
    err, n_iter, err_hist); callers apply ``cleanup_voltages``."""
    idx = consts.idx
    H, n, m, c = idx.H, idx.n, idx.m, idx.c
    B = V_m.shape[-1]
    rd, dv = V_m.dtype, V_m.device
    if f0 is None:
        f, err = mismatch_lanes(V_m, V_a, Y, S, dev, inj_db, m, n, c, lineY,
                                ibg=ibg, mesh=mesh)
    else:
        f, err = f0
    hist = torch.full((settings.max_iter_h, B), float("nan"), dtype=rd,
                      device=dv)
    D = H * n
    x = torch.cat([V_a.reshape(D, B)[1:], V_m.reshape(D, B)[c:]], dim=0)

    it = torch.zeros((B,), dtype=torch.int32, device=dv)
    t = 0
    # a lifted lane stops only after a short trip, so it takes one from
    # wherever it starts (:func:`hpfx_torch.harmonic.lifted_threshold`)
    lifted = lifted_threshold(thresh_eff, settings)
    act = ((err > thresh_eff) | lifted) & (it < settings.max_iter_h)
    go = _read(log, bool, act.any())
    t_read = _clock(log)
    while go:
        with _span("trip"):
            _trip(log)
            impl = settings.big_solve
            if impl == "warmup":
                # blocked-Schur steps far from the root, direct steps after
                impl = "schur" if t < settings.big_solve_warmup else "direct"
            dx = arrow_step_lanes(V_m, V_a, f, Y, dev, inj_db, consts,
                                  big_solve=impl, mesh=mesh)
            with _span("trip.mismatch"):
                # the trial state and its mismatch
                x_new = x - dx
                Va_new = torch.cat([V_a.reshape(D, B)[:1], x_new[: D - 1]],
                                   dim=0).reshape(H, n, B)
                Vm_new = torch.cat([V_m.reshape(D, B)[:c], x_new[D - 1:]],
                                   dim=0).reshape(H, n, B)
                f_new, err_new = mismatch_lanes(Vm_new, Va_new, Y, S, dev,
                                                inj_db, m, n, c, lineY,
                                                ibg=ibg, mesh=mesh)
                err_new = long_step_err(err_new, thresh_eff, lifted, V_m,
                                        V_a, Vm_new, Va_new, (0, 1),
                                        settings.step_stop)
            with _span("trip.update"):
                V_m = torch.where(act, Vm_new, V_m)
                V_a = torch.where(act, Va_new, V_a)
                x = torch.where(act, x_new, x)
                f = torch.where(act, f_new, f)
                err = torch.where(act, err_new, err)
                hist[t] = torch.where(act, err_new, hist[t])
                it = it + act.to(torch.int32)
                t += 1
                act = (err > thresh_eff) & (it < settings.max_iter_h)
            with _span("trip.read"):
                go = _read(log, bool, act.any())
        t_read = _harmonic_trip(log, t_read)
    return V_m, V_a, err, it, hist


class _SweepSetup(NamedTuple):
    """Shared pre-trip state of the lane-major sweep entry points, or of
    the lanes a rescue gathered (``fund`` then None)."""
    Y: Cx
    lineY: object
    S: Cx
    dev: object                  # LaneDevices or AnalyticDeviceSet
    inj_db: torch.Tensor
    fund: FundLanes
    cold_V_m: torch.Tensor
    cold_V_a: torch.Tensor
    consts: _ArrowConsts
    thresh: torch.Tensor         # floor-aware, evaluated at the COLD state
    ibg: Optional[Cx] = None     # (H, n, B) background injections


def _scenario_lanes(net: Network, devices, settings: Settings, scenarios):
    """The scenarios' scaled loads ``S`` (n, B), device-major injection
    scales ``inj_db`` (n_nl, B) and lane devices (a DeviceLibrary blended
    by ``scenarios.device_mix``)."""
    n, m = net.n, net.m
    rd, dv = settings.real_dtype, net.device
    B = scenarios.p_scale.shape[0]
    q_scale = scenarios.q_scale if scenarios.q_scale is not None \
        else scenarios.p_scale
    inj = scenarios.injection_scale if scenarios.injection_scale is not None \
        else torch.ones((B,), dtype=rd, device=dv)
    inj = inj.to(rd)
    # per-device scales arrive batch-major (B, n_nl); lanes carry (n_nl, B)
    inj_db = _as_inj_db(inj.T if inj.ndim == 2 else inj, n - m, B)
    mix = getattr(scenarios, "device_mix", None)
    if (mix is not None) != isinstance(devices, DeviceLibrary):
        raise ValueError(
            "Scenarios.device_mix requires passing a DeviceLibrary as "
            "devices (and vice versa)")
    dev = (_mix_lane_devices(devices, mix, rd) if mix is not None
           else _as_lane_devices(devices))
    S = Cx(_scale_cols(net.bus_P, scenarios.p_scale),
           _scale_cols(net.bus_Q, q_scale))
    return S, inj_db, dev


def _cold_start(Y: Cx, lineY_f, S: Cx, net: Network, settings: Settings,
                log: Optional[PhaseLog] = None):
    """The batched fundamental solve of the loads ``S`` and the flat
    harmonic start on it: (fund, V_m, V_a), the voltages (H, n, B)."""
    H, n, B = settings.n_harmonics, net.n, S.re.shape[-1]
    rd, dv = settings.real_dtype, net.device
    fund = solve_fundamental_lanes(Y[0], S, net, settings, B, lineY_f,
                                   log=log)
    V_m = torch.full((H, n, B), settings.v_init_h, dtype=rd, device=dv)
    V_a = torch.full((H, n, B), settings.a_init_h, dtype=rd, device=dv)
    V_m[0], V_a[0] = fund.V_m, fund.V_a
    return fund, V_m, V_a


def _gather_lanes(sel, S: Cx, inj_db, dev):
    """The lanes ``sel`` of the loads, the injection scales and the lane
    devices (a device mix's own arrays)."""
    g = lambda x: x.index_select(-1, sel)
    gcx = lambda z: Cx(g(z.re), g(z.im))
    if isinstance(dev, LaneDevices) and dev.batched:
        dev = dev._replace(I_N=gcx(dev.I_N), Y_N=gcx(dev.Y_N))
    return gcx(S), g(inj_db), dev


def _scatter_lanes(full, kk, sel, mask):
    """``full`` with its lanes ``sel`` (last axis) replaced by ``kk`` where
    ``mask`` (one flag a lane of ``sel``)."""
    out = full.clone()
    out[..., sel] = torch.where(mask, kk, full.index_select(-1, sel))
    return out


def _sweep_setup(net: Network, devices, settings: Settings, scenarios,
                 Y=None, I_bg=None, log: Optional[PhaseLog] = None
                 ) -> _SweepSetup:
    """Admittances (``Y``: None, a dense Cx or a (Y, lineY, lineY_f)
    triple, :func:`hpfx_torch.ybus.resolve_ybus`), the scenario inputs
    (:func:`_scenario_lanes`), the cold start (:func:`_cold_start`), the
    background injections ``I_bg`` (batch-major (B, H, n), carried (H, n,
    B)), the cached arrow constants and the floor-aware threshold
    (evaluated at the cold state even for warm starts)."""
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    rd, dv = settings.real_dtype, net.device
    Y, lineY, lineY_f = resolve_ybus(net, settings, Y)
    S, inj_db, dev = _scenario_lanes(net, devices, settings, scenarios)
    fund, cold_V_m, cold_V_a = _cold_start(Y, lineY_f, S, net, settings, log)
    ibg = None
    if I_bg is not None:
        ibg = Cx(torch.movedim(I_bg.re.to(rd), 0, -1),
                 torch.movedim(I_bg.im.to(rd), 0, -1))
    consts = _consts(H, n, m, c, rd, dv)
    thresh = _thresh_lanes(cold_V_m, Y, dev, inj_db, m, settings, ibg=ibg)
    return _SweepSetup(Y, lineY, S, dev, inj_db, fund, cold_V_m,
                       cold_V_a, consts, thresh, ibg)


def _rescue_pass(su: _SweepSetup, settings: Settings, Vm0, Va0, state,
                 log: Optional[PhaseLog] = None, mesh=ALONE):
    """One Newton pass of the gathered lanes ``su`` from (Vm0, Va0).
    ``state``: their (V_m, V_a, err, n_iter, converged).  Only the results
    of the lanes given unconverged are kept, so the converged ones take an
    infinite threshold: no trip from the first read (the threshold is not
    lifted, :func:`hpfx_torch.harmonic.lifted_threshold`), and the loop
    ends when the kept lanes are done.  Returns the new state, the kept
    lanes ``redo`` and the pass's (max_iter_h, K) history."""
    Vmk, Vak, errk, nitk, convk = state
    thresh_r = su.thresh.masked_fill(convk, float("inf"))
    Vm2, Va2, err2, nit2, hist2 = nr_trip_lanes(
        su.Y, su.lineY, su.S, su.dev, su.inj_db, Vm0, Va0, settings,
        su.consts, thresh_r, ibg=su.ibg, log=log, mesh=mesh)
    redo = ~convk
    Vmk = torch.where(redo, Vm2, Vmk)
    Vak = torch.where(redo, Va2, Vak)
    errk = torch.where(redo, err2, errk)
    nitk = nitk + torch.where(redo, nit2, 0)
    convk = convk | (redo & (err2 <= thresh_r))
    return (Vmk, Vak, errk, nitk, convk), redo, hist2


def _mesh_piece(mesh, scenarios, V0=None, I_bg=None):
    """This rank's contiguous piece of the whole batch (and of ``V0`` and
    ``I_bg``) on the scenario axis of ``mesh``."""
    lo, hi = mesh.bounds(scenarios.p_scale.shape[0])
    return (type(scenarios)(*(None if x is None else x[lo:hi]
                              for x in scenarios)),
            None if V0 is None else tuple(v[lo:hi] for v in V0),
            None if I_bg is None else Cx(I_bg.re[lo:hi], I_bg.im[lo:hi]))


def hpf_sweep_lanes(net: Network, devices, settings: Settings,
                    scenarios, V0=None, Y=None, I_bg=None,
                    log: Optional[PhaseLog] = None, mesh=ALONE) -> HPFResult:
    """Batched HPF sweep with the scenario batch lane-minor throughout;
    returns the batch-major ``HPFResult``.  ``V0``: optional batch-major
    (B, H, n) (V_m, V_a) start, used as given; ``Y``, ``I_bg`` as in
    :func:`_sweep_setup`.

    ``mesh``: a scenario, harmonic or 2-D mesh (:func:`hpfx_torch.
    parallel.hpf_sweep_sharded2d`); every rank passes the whole batch (and
    ``V0``, ``I_bg``), solves its contiguous piece on the scenario axis
    with the Newton trip split over its harmonic group, and returns that
    piece's result.  JAX's ``vsharding=NamedSharding(mesh, P(harmonic,
    None, scenario))`` is ``mesh=hpf_mesh(...)`` here."""
    scenarios, V0, I_bg = _mesh_piece(mesh, scenarios, V0, I_bg)
    su = _sweep_setup(net, devices, settings, scenarios, Y=Y, I_bg=I_bg,
                      log=log)
    if V0 is None:
        V_m, V_a = su.cold_V_m, su.cold_V_a
    else:
        rd = settings.real_dtype
        V_m = torch.movedim(V0[0].to(rd), 0, -1)
        V_a = torch.movedim(V0[1].to(rd), 0, -1)
    V_m, V_a, err, n_iter, hist = nr_trip_lanes(
        su.Y, su.lineY, su.S, su.dev, su.inj_db, V_m, V_a, settings,
        su.consts, su.thresh, ibg=su.ibg, log=log, mesh=mesh)
    V_m, V_a = cleanup_voltages(V_m, V_a)
    return _lanes_result(V_m, V_a, err, n_iter, hist, su.thresh, su.fund)


def _linear_seed_lanes(su: _SweepSetup, net: Network, settings: Settings,
                       mesh=ALONE):
    """Exact-linear Norton seed in the lane layout: the harmonic
    current-balance rows are linear in rectangular coordinates, so one
    real-embedded (2·(H−1)·n)² solve per lane lands phase 1 on the exact
    harmonic solution at the just-solved fundamental
    (``hpfx.lanes._linear_seed_lanes``).  Needs Norton LaneDevices,
    batched (a device mix) or not; background injections move to the
    right-hand side.  ``mesh``: a mesh whose harmonic group splits the
    lanes' solves and all-gathers them.  Returns the (H, n, B) start."""
    H, n, m = settings.n_harmonics, net.n, net.m
    K, rd = H - 1, settings.real_dtype
    dev, inj = su.dev, su.inj_db                      # inj: (n_nl, B)
    B, dv = inj.shape[-1], inj.device
    eyeN = torch.eye(n, dtype=rd, device=dv)
    eyeK = torch.eye(K, dtype=rd, device=dv)
    # device arrays with a trailing lane axis (of size 1 when shared)
    lane = lambda a: _lane(a, dev.batched)

    # per-lane device coupling, scaled like _injections_lanes:
    # D[h, p, i, b] on the nonlinear buses
    YN, IN = dev.Y_N, dev.I_N
    D_re = torch.zeros((K, K, n, B), dtype=rd, device=dv)
    D_im = torch.zeros((K, K, n, B), dtype=rd, device=dv)
    if dev.coupled:
        s_ = inj[:, None, None, :]
        D_re[:, :, m:, :] = torch.movedim(lane(YN.re[:, 1:, 1:]) * s_, 0, 2)
        D_im[:, :, m:, :] = torch.movedim(lane(YN.im[:, 1:, 1:]) * s_, 0, 2)
    else:
        s_ = inj[:, None, :]
        i = torch.arange(K, device=dv)
        D_re[i, i, m:, :] = torch.movedim(lane(YN.re[:, 1:]) * s_, 0, 1)
        D_im[i, i, m:, :] = torch.movedim(lane(YN.im[:, 1:]) * s_, 0, 1)

    # A = blockdiag(Y) − δ_ij·D, lane-major (K·n, K·n, lanes)
    def assemble(Ypart, D):
        Dt = D.transpose(1, 2)                        # (h, i, p, b)
        t = Dt[:, :, :, None, :] * eyeN[None, :, None, :, None]
        blockdiag = eyeK[:, None, :, None] * Ypart[:, :, None, :]
        return (blockdiag[..., None] - t).reshape(K * n, K * n, -1)

    V1 = cx.polar(su.fund.V_m, su.fund.V_a)           # (n, B)
    si = inj[:, None, :]
    rhs_nl = -(Cx(lane(IN.re[:, 1:]), lane(IN.im[:, 1:])) * si)
    if dev.coupled:
        col0 = Cx(lane(YN.re[:, 1:, 0]), lane(YN.im[:, 1:, 0]))
        rhs_nl = rhs_nl + (col0 * si) * V1[m:][:, None, :]
    rhs = cx.zeros((K, n, B), rd, dv).at_set(
        (_all, slice(m, None), _all),
        Cx(torch.movedim(rhs_nl.re, 0, 1), torch.movedim(rhs_nl.im, 0, 1)))
    if su.ibg is not None:
        rhs = rhs - su.ibg[1:]

    N = K * n

    def solve_lanes(lo, hi):
        Ar = assemble(su.Y.re[1:], D_re[..., lo:hi])
        Ai = assemble(su.Y.im[1:], D_im[..., lo:hi])
        A_real = torch.cat([torch.cat([Ar, -Ai], dim=1),
                            torch.cat([Ai, Ar], dim=1)], dim=0)
        b_real = torch.cat([rhs.re[..., lo:hi].reshape(N, -1),
                            rhs.im[..., lo:hi].reshape(N, -1)],
                           dim=0)[:, None, :]
        return batched_solve_lanes(A_real, b_real)[:, 0, :]

    # the (2N, 2N, lanes) system of this rank's lanes is chunked over
    # lanes to a memory budget (a no-op at net2 B=16384: ~0.6 GB)
    l0, l1 = mesh.hbounds(B)
    bytes_per_lane = (2 * N) ** 2 * torch.finfo(rd).bits // 8
    chunk = int(max(1, min(B, SEED_CHUNK_BYTES // bytes_per_lane)))
    x = torch.cat([rhs.re.new_zeros((2 * N, 0))]
                  + [solve_lanes(lo, min(lo + chunk, l1))
                     for lo in range(l0, l1, chunk)], dim=-1)
    x = mesh.hgather(x, B, -1)                             # (2N, B)

    Vh = Cx(x[:N].reshape(K, n, B), x[N:].reshape(K, n, B))
    V_m = torch.cat([su.fund.V_m[None], _floor_seed_mag(Vh.abs(), settings)])
    V_a = torch.cat([su.fund.V_a[None], Vh.angle()])
    return V_m, V_a


def hpf_sweep_adaptive_lanes(net: Network, devices, settings: Settings,
                             scenarios, phase_iters: int = 24,
                             rescue_width=None, warm: str = "cold",
                             V0=None, I_bg=None,
                             log: Optional[PhaseLog] = None,
                             mesh=ALONE) -> HPFResult:
    """Two-phase adaptive sweep with a gathered straggler rescue
    (``hpfx.lanes.hpf_sweep_adaptive_lanes``):

      1. phase 1: full-width trip capped at ``phase_iters``, from the cold
         flat start, an explicit ``V0`` (batch-major (B, H, n), its
         fundamental row replaced by the sweep's own fundamental) or
         (``warm="linear"``, Norton devices) the exact-linear seed;
      2. phase 2: the ``rescue_width`` worst lanes (default
         ``max(128, B // 16)``) are gathered into a narrow batch; those
         still unconverged continue warm from their own phase-1 state
         with the remaining budget;
      3. cold restart: gathered lanes still unconverged restart from the
         flat start with a fresh full budget;
      4. scatter back, splicing full-width ``err_hist``.

    Both passes (:func:`_rescue_pass`) run only the lanes they were given
    unconverged.  Where phase 1 left no gathered lane unconverged (one
    host read), neither runs; their phases still open, empty.

    Stragglers beyond the width keep their phase-1 state and are reported
    unconverged.  A tuple ``rescue_width`` gives bucketed widths: the
    smallest that covers the phase-1 straggler count is chosen on the
    host (one synchronisation), where the JAX package's ``lax.switch``
    picks it on the device; with the stragglers inside it, the result is
    that of the single width of that size, bit for bit.  ``I_bg``:
    optional batch-major (B, H, n) background injections.  ``log``:
    optional :class:`PhaseLog`.

    ``mesh``: a scenario, harmonic or 2-D mesh (:func:`hpfx_torch.
    parallel.hpf_sweep_adaptive_sharded`); every rank passes the whole
    batch (and ``V0``, ``I_bg``), solves its contiguous piece with each
    Newton trip and the seed split over its harmonic group, and returns
    that piece's result.  The straggler choice stays global: the phase-1
    convergence masks of every scenario rank are gathered, every rank
    picks the same ``K`` lanes of the whole batch, and each rescues the
    ones it holds."""
    dv = net.device
    Bg = scenarios.p_scale.shape[0]
    lo, hi = mesh.bounds(Bg)
    scenarios, V0, I_bg = _mesh_piece(mesh, scenarios, V0, I_bg)
    with _phase(log, "setup", dv):
        su = _sweep_setup(net, devices, settings, scenarios, I_bg=I_bg,
                          log=log)
    rd = settings.real_dtype
    B = scenarios.p_scale.shape[0]
    p1 = min(phase_iters, settings.max_iter_h)

    # the cold state keeps its roles in the floor-aware threshold and the
    # cold restart whatever phase 1 starts from
    if V0 is not None:
        Vm1 = torch.movedim(V0[0].to(rd), 0, -1).clone()
        Va1 = torch.movedim(V0[1].to(rd), 0, -1).clone()
        Vm1[0], Va1[0] = su.fund.V_m, su.fund.V_a
    elif warm == "linear" and isinstance(su.dev, LaneDevices):
        with _phase(log, "seed", dv):
            Vm1, Va1 = _linear_seed_lanes(su, net, settings, mesh=mesh)
    else:
        Vm1, Va1 = su.cold_V_m, su.cold_V_a

    with _phase(log, "phase1", dv):
        V_m, V_a, err, n_iter, hist1 = nr_trip_lanes(
            su.Y, su.lineY, su.S, su.dev, su.inj_db, Vm1, Va1,
            settings.with_(max_iter_h=p1), su.consts, su.thresh,
            ibg=su.ibg, log=log, mesh=mesh)
    conv = err <= su.thresh
    hist = torch.full((settings.max_iter_h, B), float("nan"), dtype=rd,
                      device=dv)
    hist[:p1] = hist1

    conv_g = mesh.all_gather(conv, Bg, dim=-1)
    if isinstance(rescue_width, (tuple, list)):
        widths = sorted({min(Bg, max(1, int(w))) for w in rescue_width})
        n_bad = _read(log, int, (~conv_g).sum())
        K = widths[sum(n_bad > w for w in widths[:-1])]
    else:
        K = min(Bg, rescue_width if rescue_width is not None
                else max(128, Bg // 16))
    # unconverged lanes first (stable: deterministic padding choice)
    bad = torch.argsort(conv_g.to(rd), stable=True)[:K]
    bad = _read(log, torch.masked_select, bad, (bad >= lo) & (bad < hi)) - lo
    was_bad = ~conv[bad]
    # under a mesh each scenario rank counts the lanes it holds, as its
    # trip loops read theirs; the ranks of one harmonic group hold the
    # same lanes, so they run or skip the passes, and the gathers inside
    # them, alike
    n_strag = _read(log, int, was_bad.sum())
    if log is not None:
        log.stragglers += n_strag
    g = lambda x: x.index_select(-1, bad)
    S_k, inj_k, dev_k = _gather_lanes(bad, su.S, su.inj_db, su.dev)
    su_k = su._replace(
        S=S_k, inj_db=inj_k, dev=dev_k, fund=None,
        cold_V_m=g(su.cold_V_m), cold_V_a=g(su.cold_V_a),
        thresh=g(su.thresh),
        ibg=None if su.ibg is None else Cx(g(su.ibg.re), g(su.ibg.im)))

    state = (g(V_m), g(V_a), g(err), g(n_iter), conv[bad])
    if p1 < settings.max_iter_h:
        # phase 2: continue warm from the cleaned phase-1 state (cold where
        # it went non-finite — a NaN state no-ops the trip at iteration 0)
        with _phase(log, "rescue_phase2", dv):
            if n_strag:
                Vmk, Vak = state[0], state[1]
                finite = (torch.isfinite(Vmk).flatten(0, 1).all(dim=0)
                          & torch.isfinite(Vak).flatten(0, 1).all(dim=0))
                use_self = (finite | state[4])[None, None, :]
                Vmc, Vac = cleanup_voltages(Vmk, Vak)
                s2 = settings.with_(max_iter_h=settings.max_iter_h - p1)
                state, redo, hist2 = _rescue_pass(
                    su_k, s2, torch.where(use_self, Vmc, su_k.cold_V_m),
                    torch.where(use_self, Vac, su_k.cold_V_a), state,
                    log=log, mesh=mesh)
                hist[p1:, bad] = torch.where(redo[None, :], hist2,
                                             hist[p1:, bad])

    # cold restart with a fresh full budget for anything STILL stuck; its
    # history replaces the whole row (a restart, not a resume)
    with _phase(log, "cold_restart", dv):
        if n_strag:
            state, redo, hist3 = _rescue_pass(
                su_k, settings, su_k.cold_V_m, su_k.cold_V_a, state,
                log=log, mesh=mesh)
            hist[:, bad] = torch.where(redo[None, :], hist3, hist[:, bad])

    if n_strag:
        V_m, V_a, err, n_iter, conv = (
            _scatter_lanes(x, k, bad, was_bad)
            for x, k in zip((V_m, V_a, err, n_iter, conv), state))

    V_m, V_a = cleanup_voltages(V_m, V_a)
    res = _lanes_result(V_m, V_a, err, n_iter, hist, su.thresh, su.fund)
    return res._replace(converged=conv)


def _lanes_result(V_m, V_a, err, n_iter, hist, thresh_eff,
                  fund: FundLanes) -> HPFResult:
    fund_bm = FundResult(V_m=fund.V_m.T, V_a=fund.V_a.T, err=fund.err,
                         n_iter=fund.n_iter, err_hist=fund.err_hist.T,
                         converged=fund.converged)
    return HPFResult(V_m=torch.movedim(V_m, -1, 0),
                     V_a=torch.movedim(V_a, -1, 0), err=err, n_iter=n_iter,
                     err_hist=hist.T, converged=err <= thresh_eff,
                     fund=fund_bm)


def _continuation_rescue(su: _SweepSetup, V_m, V_a, err, n_iter, hist,
                         conv, bad, settings: Settings, log, mesh=ALONE):
    """The device continuation's rescue of the lanes ``bad`` (``su``: their
    set-up): two passes (:func:`_rescue_pass`), warm from their own final
    state (cold where it is not finite), which breaks floor-hover stalls,
    and cold, for what a bad continuation seed stalled; each pass's
    history replaces the rescued lanes' whole rows; scattered back."""
    was_bad = ~conv[bad]
    g = lambda x: x.index_select(-1, bad)
    Vmk, Vak, histk = g(V_m), g(V_a), g(hist)
    finite = (torch.isfinite(Vmk).flatten(0, 1).all(dim=0)
              & torch.isfinite(Vak).flatten(0, 1).all(dim=0))
    use_self = finite | conv[bad]
    state = (Vmk, Vak, g(err), g(n_iter), conv[bad])
    for Vm0, Va0 in ((torch.where(use_self, Vmk, su.cold_V_m),
                      torch.where(use_self, Vak, su.cold_V_a)),
                     (su.cold_V_m, su.cold_V_a)):
        state, redo, hist_p = _rescue_pass(su, settings, Vm0, Va0, state,
                                           log=log, mesh=mesh)
        histk = torch.where(redo, hist_p, histk)
    Vmk, Vak, errk, nitk, convk = state
    return tuple(_scatter_lanes(x, k, bad, was_bad) for x, k in zip(
        (V_m, V_a, err, n_iter, hist, conv),
        (Vmk, Vak, errk, nitk, histk, convk)))


def hpf_sweep_continuation_lanes(net: Network, devices, settings: Settings,
                                 scenarios, n_stages: int = 8,
                                 rescue: bool = True,
                                 log: Optional[PhaseLog] = None,
                                 mesh=ALONE) -> HPFResult:
    """The warm-start continuation with its whole schedule on the device
    (``hpfx.lanes.hpf_sweep_continuation_lanes``): the key sort, the
    chunks, each stage seeded from the nearest CONVERGED scenario of the
    previous chunk, and two gathered rescue passes.  The stages are a
    host loop around :func:`nr_trip_lanes`; beyond the one sync a Newton
    trip makes, nothing comes back to the host (the seed's choice is a
    ``torch.where`` on the device).

    The key: the injection scale (per-device scales averaged), else the
    summed device mix, else ``p_scale``; sorted stably, split into
    ``n_stages`` chunks, the last padded with repeats of the last sorted
    index.  Every stage's floor-aware threshold is taken at its cold
    state, as the plain sweep's.  With ``rescue``, up to one chunk width
    of unconverged scenarios are gathered (stably) and re-solved
    (:func:`_continuation_rescue`).  ``log``: optional :class:`PhaseLog`
    with the phases "stages" and "rescue".

    ``mesh``: a scenario, harmonic or 2-D mesh (:func:`hpfx_torch.
    parallel.hpf_sweep_continuation_sharded`; JAX's ``vsharding=
    NamedSharding(mesh, P(harmonic, None, scenario))`` is ``mesh=
    hpf_mesh(...)`` here); every rank passes the whole batch.  The key
    sort and the chunks stay global: each scenario rank solves its
    contiguous piece of every chunk, its Newton trips split over its
    harmonic group, and the chunk's states are gathered after each stage,
    since the next chunk's seeds are chosen from all of them.  The
    rescue's lanes are chosen from the whole batch and each scenario rank
    rescues those in its piece of it."""
    H, n, m, c = settings.n_harmonics, net.n, net.m, net.c
    rd, dv = settings.real_dtype, net.device
    B = scenarios.p_scale.shape[0]
    n_stages = max(1, min(n_stages, B))
    Y, lineY, lineY_f = resolve_ybus(net, settings)
    S, inj_db, dev = _scenario_lanes(net, devices, settings, scenarios)
    consts = _consts(H, n, m, c, rd, dv)

    # the continuation key (the device-side twin of the host version's)
    if scenarios.injection_scale is not None:
        inj = scenarios.injection_scale.to(rd)
        key = inj if inj.ndim == 1 else inj.mean(dim=1)
    elif getattr(scenarios, "device_mix", None) is not None:
        key = scenarios.device_mix.to(rd).sum(dim=(1, 2))
    else:
        p = scenarios.p_scale.to(rd)
        key = p if p.ndim == 1 else p.mean(dim=1)
    order = torch.argsort(key, stable=True)
    Bc = -(-B // n_stages)
    Bp = n_stages * Bc
    order_p = torch.cat([order, order[-1:].expand(Bp - B)])

    def setup_of(sel) -> _SweepSetup:
        """The lanes ``sel``: inputs, cold start and the floor-aware
        threshold at it, the plain sweep's bar (at a warm seed the
        harmonic |V|, and the floor with it, is ~10x smaller: knife-edge
        scenarios would meet a stricter test than on the other paths)."""
        S_k, inj_k, dev_k = _gather_lanes(sel, S, inj_db, dev)
        fund, Vm, Va = _cold_start(Y, lineY_f, S_k, net, settings, log)
        return _SweepSetup(Y, lineY, S_k, dev_k, inj_k, fund, Vm, Va,
                           consts, _thresh_lanes(Vm, Y, dev_k, inj_k, m,
                                                 settings))

    pVm = torch.zeros((H, n, Bc), dtype=rd, device=dv)
    pVa = torch.zeros_like(pVm)
    pK = torch.zeros((Bc,), dtype=rd, device=dv)
    pConv = torch.zeros((Bc,), dtype=rd, device=dv)
    outs = []
    lo, hi = mesh.bounds(Bc)
    with _phase(log, "stages", dv):
        for st in range(n_stages):
            sel = order_p[st * Bc:(st + 1) * Bc]
            su = setup_of(sel[lo:hi])
            kc = key.index_select(0, sel)
            # the nearest CONVERGED scenario of the previous chunk
            dist = (kc[lo:hi, None] - pK[None, :]).abs() \
                + 1e30 * (1.0 - pConv)[None, :]
            j = torch.argmin(dist, dim=1)
            haveprev = (pConv > 0).any()
            Vm0 = torch.where(haveprev, pVm[:, :, j], su.cold_V_m)
            Va0 = torch.where(haveprev, pVa[:, :, j], su.cold_V_a)
            Vm, Va, err, n_it, hist = nr_trip_lanes(
                Y, lineY, su.S, su.dev, su.inj_db, Vm0, Va0, settings,
                consts, su.thresh, log=log, mesh=mesh)
            conv = err <= su.thresh
            Vm, Va, err, n_it, hist, conv = (
                mesh.all_gather(x, Bc, dim=-1)
                for x in (Vm, Va, err, n_it, hist, conv))
            pVm, pVa, pK, pConv = Vm, Va, kc, conv.to(rd)
            outs.append((Vm, Va, err, n_it, hist, conv))

    def unchunk(xs):
        """The stages' (..., Bc) pieces -> (..., B) in the original order."""
        flat = torch.cat(xs, dim=-1)[..., :B]
        out = torch.zeros_like(flat)
        out[..., order] = flat
        return out

    V_m, V_a, err, n_iter, hist, conv = map(unchunk, zip(*outs))

    if rescue:
        with _phase(log, "rescue", dv):
            # up to one chunk width of unconverged lanes (a stable sort:
            # the padding's choice is deterministic)
            bad = torch.argsort(conv.to(rd), stable=True)[:min(Bc, B)]
            lo, hi = mesh.bounds(B)
            bad = _read(log, torch.masked_select, bad,
                        (bad >= lo) & (bad < hi))
            out = _continuation_rescue(setup_of(bad), V_m, V_a, err,
                                       n_iter, hist, conv, bad, settings,
                                       log, mesh=mesh)
            out = tuple(mesh.all_gather(x[..., lo:hi], B, dim=-1)
                        for x in out)
            V_m, V_a, err, n_iter, hist, conv = out

    V_m, V_a = cleanup_voltages(V_m, V_a)
    return HPFResult(V_m=torch.movedim(V_m, -1, 0),
                     V_a=torch.movedim(V_a, -1, 0), err=err, n_iter=n_iter,
                     err_hist=hist.T, converged=conv, fund=None)
