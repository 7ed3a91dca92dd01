"""IEC 61000-3-6 aggregation: the general summation law and emission
apportioning (the port of :mod:`hpfx.iec`).

- **general summation law**: ``U_h = (sum_k U_{h,k}^alpha)^(1/alpha)``
  with alpha = 1 below the 5th order, 1.4 for orders 5-10 and 2 above
  the 10th (:func:`summation_law`; :func:`aggregate_contributions` on the
  per-device contributions of
  :func:`hpfx_torch.impedance.distortion_contributions`);
- **apportioning**: ``E_{h,i} = L_h · (S_i / S_t)^(1/alpha)``
  (:func:`apportion_planning_level`).

Elementwise tensor arithmetic on any leading shape; results follow the
device of their inputs (host numbers go to the CPU).
"""
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["summation_alpha", "summation_law", "aggregate_contributions",
           "apportion_planning_level"]


def summation_alpha(harmonics: Sequence[float]) -> np.ndarray:
    """(H,) standard summation exponents: 1.0 below the 5th, 1.4 for
    orders 5-10, 2.0 above the 10th (IEC/TR 61000-3-6 table 2.2)."""
    h = np.asarray(harmonics, float)
    return np.where(h < 5.0, 1.0, np.where(h <= 10.0, 1.4, 2.0))


def _tensor(x, like=None):
    if isinstance(x, torch.Tensor):
        return x
    if like is None:
        return torch.as_tensor(np.asarray(x, float))
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def summation_law(mags, harmonics: Optional[Sequence[float]] = None,
                  alpha=None, axis: int = 0,
                  h_axis: int = -1) -> torch.Tensor:
    """Combine source magnitudes along ``axis`` under
    ``(sum m^alpha)^(1/alpha)``: an explicit ``alpha`` (scalar or
    broadcastable), or ``harmonics`` for the standard per-order exponents
    laid along ``h_axis`` of the input (which must differ from
    ``axis``)."""
    mags = _tensor(mags)
    if (alpha is None) == (harmonics is None):
        raise ValueError("pass exactly one of alpha / harmonics")
    if alpha is None:
        a = torch.as_tensor(summation_alpha(harmonics), dtype=mags.dtype,
                            device=mags.device)
        shape = [1] * mags.dim()
        shape[h_axis % mags.dim()] = -1
        if h_axis % mags.dim() == axis % mags.dim():
            raise ValueError("h_axis must differ from the source axis")
        alpha = a.reshape(shape)
    else:
        alpha = _tensor(alpha, mags)
    s = (mags.abs() ** alpha).sum(dim=axis)
    # the exponent loses its source axis in the reduction
    if alpha.dim() == mags.dim():
        alpha = alpha.squeeze(axis % mags.dim())
    return s ** (1.0 / alpha)


def aggregate_contributions(contrib, harmonics,
                            alpha=None) -> torch.Tensor:
    """Planning-level combination of the (H, n, n_nl) split-complex
    per-device voltage contributions: (H, n) combined |V_h| per bus under
    the summation law (the standard exponents, or ``alpha``)."""
    mags = torch.sqrt(contrib.re ** 2 + contrib.im ** 2)     # (H, n, n_nl)
    if alpha is None:
        return summation_law(mags, harmonics=harmonics, axis=-1, h_axis=0)
    return summation_law(mags, alpha=alpha, axis=-1)


def apportion_planning_level(L_h, S_agreed, S_total=None,
                             harmonics: Optional[Sequence[float]] = None,
                             alpha=None) -> torch.Tensor:
    """Per-customer emission limits ``E_{h,i} = L_h·(S_i/S_t)^(1/alpha)``
    from a planning level ``L_h`` (scalar or (H,)) and (K,) agreed powers;
    ``S_total`` defaults to their sum.  ``harmonics`` gives the standard
    exponents and a (K, H) result, a scalar ``alpha`` a (K,) × L_h's
    shape one."""
    S = _tensor(S_agreed)
    if not S.is_floating_point():
        S = S.to(torch.get_default_dtype())
    St = S.sum() if S_total is None else _tensor(S_total, S)
    frac = S / St                                            # (K,)
    if (alpha is None) == (harmonics is None):
        raise ValueError("pass exactly one of alpha / harmonics")
    L = _tensor(L_h, S)
    if alpha is None:
        a = torch.as_tensor(summation_alpha(harmonics), dtype=S.dtype,
                            device=S.device)                 # (H,)
        return L * frac[:, None] ** (1.0 / a)[None, :]
    return L * frac ** (1.0 / _tensor(alpha, S))
