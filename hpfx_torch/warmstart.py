"""Exact-linear Norton warm start helpers (``hpfx.warmstart``).

The seed solve itself runs in the lane layout,
``hpfx_torch.lanes._linear_seed_lanes``.
"""
from __future__ import annotations

import torch

from .config import Settings


def _floor_seed_mag(V_m_h, settings: Settings):
    """Lift seeded harmonic magnitudes that solved to exact zero (a
    harmonic order with no source) away from the polar singularity, where
    the angle-Jacobian column vanishes; sourced magnitudes are untouched."""
    eps = torch.full_like(V_m_h, 1e-2 * settings.v_init_h)
    return torch.where(V_m_h < 1e-20, eps, V_m_h)
