"""Result of the fundamental-frequency power flow (``hpfx.fundamental``).

The batched fundamental Newton solve itself lives in
``hpfx_torch.lanes.solve_fundamental_lanes``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FundResult(NamedTuple):
    V_m: torch.Tensor       # (n,) or batch-major (B, n)
    V_a: torch.Tensor
    err: torch.Tensor       # final max-abs mismatch
    n_iter: torch.Tensor
    err_hist: torch.Tensor  # (max_iter_f,), NaN-padded
    converged: torch.Tensor
