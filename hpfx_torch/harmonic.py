"""Harmonic power-flow result and post-processing (``hpfx.harmonic``)."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .fundamental import FundResult


class HPFResult(NamedTuple):
    V_m: torch.Tensor          # (H, n) or batch-major (B, H, n), cleaned
    V_a: torch.Tensor          # angles in [0, 2pi)
    err: torch.Tensor
    n_iter: torch.Tensor
    err_hist: torch.Tensor     # (max_iter_h,) or (B, max_iter_h), NaN-padded
    converged: torch.Tensor
    fund: Optional[FundResult] = None


def cleanup_voltages(V_m, V_a):
    """Post-loop sign/angle normalization (hcne_generalized.py:546-549):
    add pi to angles of negative magnitudes, wrap angles to [0, 2pi), flip
    magnitude signs."""
    neg = V_m < 0
    V_a = torch.remainder(torch.where(neg, V_a + math.pi, V_a), 2 * math.pi)
    return torch.where(neg, -V_m, V_m), V_a
