"""Structure-exploiting Newton step: block-diagonal solves plus Woodbury
(the port of :mod:`hpfx.arrow`).

The harmonic Jacobian is block-diagonal once rows and columns are grouped
by harmonic, one (2n-1-c) fundamental block and H-1 blocks of 2n, apart
from the Norton coupling of the nonlinear buses, a correction supported
on r = 2·H·n_nl coordinates:

    J_pi = D + U·C·V^T,  J^{-1} f = z − D^{-1} U (I_r + C·G)^{-1} C·(V^T z),
    z = D^{-1} f,  G = V^T D^{-1} U  (block-diagonal over harmonics).

:class:`ArrowIndex` holds the static host-side maps between the
reference's state/mismatch layout (hcne_generalized.py:393-398, 469-472)
and the grouped one.  :func:`build_arrow_pieces` and :func:`arrow_solve`
are the single-scenario step (leading scenario axes are a batch);
``hpfx_torch.lanes.arrow_step_lanes`` is the lane-major one.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import cx
from .cx import Cx
from .fundamental import _power_jacobian_blocks
from .harmonic import norton_coupling
from .ops.batched_solve import nr_solve, solve_blocks
from .parallel.mesh import ALONE


class ArrowIndex(NamedTuple):
    """Static index maps (host numpy)."""

    H: int
    n: int
    m: int
    c: int
    d0: int                 # fundamental block size (2n-1-c)
    f_perm: np.ndarray      # (dim,) original row -> grouped position
    x_perm: np.ndarray      # (dim,) original col -> grouped position
    cpl0: np.ndarray        # (2*n_nl,) coupling coords in block 0 (local)
    cplh: np.ndarray        # (2*n_nl,) coupling coords in blocks h>=1


def make_arrow_index(H: int, n: int, m: int, c: int) -> ArrowIndex:
    nl = np.arange(m, n)
    # original row offsets: P rows, Re(I) rows, Q rows, Im(I) rows, where a
    # current row (h, j) sits at (h·n + j − m) within its Re/Im section
    oRe = m - 1
    oQ = oRe + (H * n - m)
    oIm = oQ + (m - c)
    cur = lambda h, j: h * n + j - m
    # grouped order: block 0 = [P, Re(I) h=0, Q, Im(I) h=0], then per
    # harmonic h >= 1: [Re(I) h, Im(I) h]
    rows = [np.arange(0, m - 1), oRe + cur(0, nl),
            oQ + np.arange(m - c), oIm + cur(0, nl)]
    for h in range(1, H):
        rows += [oRe + cur(h, np.arange(n)), oIm + cur(h, np.arange(n))]
    # original columns: angles of flat (h, j) at h·n + j − 1 (slack angle
    # dropped), magnitudes at (H·n − 1) + (h·n + j − c)
    oMag = H * n - 1
    cols = [np.arange(1, n) - 1, oMag + np.arange(c, n) - c]
    for h in range(1, H):
        cols += [h * n + np.arange(n) - 1, oMag + h * n + np.arange(n) - c]

    def inverse(order):
        order = np.concatenate(order)
        perm = np.empty(order.size, np.int64)
        perm[order] = np.arange(order.size)
        return perm

    cpl0 = np.concatenate([nl - 1, (n - 1) + (nl - c)])
    cplh = np.concatenate([nl, n + nl])
    return ArrowIndex(H=H, n=n, m=m, c=c, d0=2 * n - 1 - c,
                      f_perm=inverse(rows), x_perm=inverse(cols),
                      cpl0=cpl0, cplh=cplh)


class _ArrowConsts(NamedTuple):
    """Constants of the arrow solve, on the solve's device."""
    idx: ArrowIndex
    E0: torch.Tensor          # (d0, r_blk) unit columns of U, block 0
    Eh: torch.Tensor          # (2n, r_blk) unit columns of U, blocks h>=1
    inv_f_perm: torch.Tensor  # (dim,) grouped row -> original position
    x_perm: torch.Tensor      # (dim,) original col -> grouped position
    cpl0: torch.Tensor
    cplh: torch.Tensor


def _make_arrow_consts(H: int, n: int, m: int, c: int, dtype,
                       device=None) -> _ArrowConsts:
    idx = make_arrow_index(H, n, m, c)
    n_nl = n - m
    r_blk = 2 * n_nl
    rows0 = np.concatenate([(m - 1) + np.arange(n_nl),
                            (m - 1) + n_nl + (m - c) + np.arange(n_nl)])
    rowsh = np.concatenate([np.arange(m, n), n + np.arange(m, n)])
    E0 = np.zeros((idx.d0, r_blk))
    E0[rows0, np.arange(r_blk)] = 1.0
    Eh = np.zeros((2 * n, r_blk))
    Eh[rowsh, np.arange(r_blk)] = 1.0
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return _ArrowConsts(idx=idx, E0=f(E0), Eh=f(Eh),
                        inv_f_perm=i(np.argsort(idx.f_perm)),
                        x_perm=i(idx.x_perm), cpl0=i(idx.cpl0),
                        cplh=i(idx.cplh))


@functools.lru_cache(maxsize=16)
def _consts(H: int, n: int, m: int, c: int, dtype, device) -> _ArrowConsts:
    return _make_arrow_consts(H, n, m, c, dtype, device)


class ArrowPieces(NamedTuple):
    D0: torch.Tensor       # (..., d0, d0) fundamental block
    Dh: torch.Tensor       # (..., H-1, 2n, 2n) harmonic blocks (a rank's)
    C: torch.Tensor        # (..., r, r) coupling matrix (zero off the devices)


def build_arrow_pieces(V_m, V_a, Y: Cx, devices,
                       idx: ArrowIndex, mesh=ALONE) -> ArrowPieces:
    """Assemble the block-diagonal and coupling parts of the Jacobian
    (``hpfx.arrow.build_arrow_pieces``); the Norton coupling is the dense
    Jacobian's (:func:`hpfx_torch.harmonic.norton_coupling`, the JAX
    package's ``_coupling_cx``).  ``mesh``: a mesh whose harmonic group
    splits the blocks: this rank's ``Dh`` holds its harmonics >= 1 only,
    and ``D0`` is built by the rank of harmonic 0 (None elsewhere)."""
    H, n, m, c = idx.H, idx.n, idx.m, idx.c
    n_nl = n - m
    h0, h1 = mesh.hbounds(H)
    s0 = max(h0, 1)
    V_c = cx.polar(V_m, V_a)
    Vn = cx.expj(V_a)
    row = lambda z: Cx(z.re[..., h0:h1, None, :], z.im[..., h0:h1, None, :])
    K_V, K_A = norton_coupling(V_m, V_a, devices, m)

    # fold the h == p coupling into the diagonal blocks
    nl = torch.arange(m, n, device=V_m.device)
    hh = torch.arange(h0, h1, device=V_m.device)

    def fold(blocks: Cx, K: Cx) -> Cx:
        def one(b, k):
            b = b.clone()
            b[..., nl, nl] += k[..., hh, hh, :]
            return b
        return Cx(one(blocks.re, K.re), one(blocks.im, K.im))

    Yl = Y[..., h0:h1, :, :]
    M_V = fold(Yl * row(Vn), K_V)                       # (..., Hl, n, n)
    M_A = fold((Yl * row(V_c)).jmul(), K_A)
    hcat = lambda a, b: torch.cat([a, b], dim=-1)
    D0 = None
    if h0 == 0:
        dS1dA1, dS1dV1 = _power_jacobian_blocks(
            V_c[..., 0, :], Vn[..., 0, :], Y[..., 0, :, :], n)
        D0 = torch.cat([
            hcat(dS1dA1.re[..., 1:m, 1:], dS1dV1.re[..., 1:m, c:]),
            hcat(M_A.re[..., 0, m:, 1:], M_V.re[..., 0, m:, c:]),
            hcat(dS1dA1.im[..., c:m, 1:], dS1dV1.im[..., c:m, c:]),
            hcat(M_A.im[..., 0, m:, 1:], M_V.im[..., 0, m:, c:]),
        ], dim=-2)
    k = s0 - h0
    Dh = torch.cat([hcat(M_A.re[..., k:, :, :], M_V.re[..., k:, :, :]),
                    hcat(M_A.im[..., k:, :, :], M_V.im[..., k:, :, :])],
                   dim=-2)                              # (..., h1-s0, 2n, 2n)

    # the coupling matrix C (r x r): u = h·(2·n_nl) + t·n_nl + d, rows
    # (Re, Im), columns (angle, magnitude); only h != p, d == d' entries
    r = 2 * H * n_nl
    off = ~torch.eye(H, dtype=torch.bool, device=V_m.device)[:, :, None]
    keep = lambda z: torch.where(off, z, torch.zeros_like(z))
    Cfull = torch.stack([
        torch.stack([keep(K_A.re), keep(K_V.re)], dim=-1),    # Re row
        torch.stack([keep(K_A.im), keep(K_V.im)], dim=-1),    # Im row
    ], dim=-2)                                  # (..., H, H, n_nl, 2, 2)
    eye_d = torch.eye(n_nl, dtype=V_m.dtype, device=V_m.device)
    C = torch.einsum("...hpdrc,de->...hrdpce", Cfull, eye_d)
    return ArrowPieces(D0=D0, Dh=Dh, C=C.reshape(C.shape[:-6] + (r, r)))


def arrow_solve(pieces: ArrowPieces, f, idx: ArrowIndex, mesh=ALONE):
    """Solve J dx = f with the block and Woodbury structure
    (``hpfx.arrow.arrow_solve``): the fundamental block identity-padded to
    2n, every block's f and U columns in one multi-RHS
    :func:`solve_blocks`, and the capacitance system I + C·G by
    :func:`nr_solve`.  ``mesh``: a mesh whose harmonic group split the
    blocks (:func:`build_arrow_pieces`): each rank solves its blocks, G
    and V^T·z are all-gathered, the capacitance system is solved whole on
    every rank, and each back-substitutes its harmonics, x all-gathered."""
    H, n, d0 = idx.H, idx.n, idx.d0
    n_nl = n - idx.m
    K, k2, r, r_blk = H - 1, 2 * n, 2 * H * n_nl, 2 * n_nl
    dt, dv = f.dtype, f.device
    k = _consts(H, n, idx.m, idx.c, dt, dv)
    batch = f.shape[:-1]
    h0, h1 = mesh.hbounds(H)
    s0 = max(h0, 1)

    fp = f[..., k.inv_f_perm]                          # grouped order
    fh = fp[..., d0:].reshape(batch + (K, k2))[..., s0 - 1:h1 - 1, :]
    D_all = pieces.Dh
    rhs_all = torch.cat([fh[..., None],
                         k.Eh.expand(batch + (h1 - s0, k2, r_blk))], dim=-1)
    if h0 == 0:
        D0p = torch.eye(k2, dtype=dt, device=dv).expand(
            batch + (k2, k2)).clone()
        D0p[..., :d0, :d0] = pieces.D0
        rhs0p = torch.zeros(batch + (k2, 1 + r_blk), dtype=dt, device=dv)
        rhs0p[..., :d0, 0] = fp[..., :d0]
        rhs0p[..., :d0, 1:] = k.E0
        D_all = torch.cat([D0p[..., None, :, :], D_all], dim=-3)
        rhs_all = torch.cat([rhs0p[..., None, :, :], rhs_all], dim=-3)
    sol = solve_blocks(D_all, rhs_all) if h1 > h0 else rhs_all

    zh, Xh = sol[..., s0 - h0:, :, 0], sol[..., s0 - h0:, :, 1:]
    # V^T picks the coupling coordinates of a grouped vector
    Vz = zh[..., k.cplh]                               # (..., h1-s0, rb)
    G = Xh[..., k.cplh, :]                             # (..., h1-s0, rb, rb)
    if h0 == 0:
        z0, X0 = sol[..., 0, :d0, 0], sol[..., 0, :d0, 1:]
        Vz = torch.cat([z0[..., k.cpl0][..., None, :], Vz], dim=-2)
        G = torch.cat([X0[..., k.cpl0, :][..., None, :, :], G], dim=-3)
    if mesh.hgroup is not None:
        zG = mesh.hgather(torch.cat([Vz[..., None], G], dim=-1), H, -3)
        Vz, G = zG[..., 0], zG[..., 1:]
    Vz = Vz.reshape(batch + (r,))
    CG = torch.einsum("...rpb,...pbs->...rps",
                      pieces.C.reshape(batch + (r, H, r_blk)), G)
    S = torch.eye(r, dtype=dt, device=dv) + CG.reshape(batch + (r, r))
    y = nr_solve(S, torch.einsum("...ij,...j->...i", pieces.C, Vz))

    yb = y.reshape(batch + (H, r_blk))
    x = zh - torch.einsum("...kds,...ks->...kd", Xh, yb[..., s0:h1, :])
    if h0 == 0:
        x0 = z0 - torch.einsum("...ds,...s->...d", X0, yb[..., 0, :])
        x0 = torch.cat([x0, x0.new_zeros(batch + (k2 - d0,))], dim=-1)
        x = torch.cat([x0[..., None, :], x], dim=-2)
    x = mesh.hgather(x, H, -2)                         # (..., H, 2n)
    return torch.cat([x[..., 0, :d0], x[..., 1:, :].flatten(-2)],
                     dim=-1)[..., k.x_perm]
