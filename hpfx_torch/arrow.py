"""Index maps of the structured (arrow) Newton step.

The harmonic Jacobian is block-diagonal once rows and columns are grouped
by harmonic, apart from the Norton coupling of the nonlinear buses (see
``hpfx.arrow``).  :class:`ArrowIndex` holds the static host-side maps
between the reference's state/mismatch layout (hcne_generalized.py
:393-398, 469-472) and that grouped layout; ``hpfx_torch.lanes`` does
the block + Woodbury solve with them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
