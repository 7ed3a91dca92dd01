"""Distortion metrics (``hpfx.results``; reference get_THD,
hcne_generalized.py:563-572)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class THD(NamedTuple):
    THD_F: torch.Tensor  # relative to fundamental
    THD_R: torch.Tensor  # relative to RMS


def get_thd(V_m: torch.Tensor) -> THD:
    """Total harmonic distortion per bus from the (H, ...) magnitude
    tensor: THD_F = sqrt(sum_{h>=3} V²)/V(h=1), THD_R = sqrt(sum_{h>=3}
    V²)/sqrt(sum_all V²)."""
    harm = torch.sqrt(torch.sum(V_m[1:] ** 2, dim=0))
    total = torch.sqrt(torch.sum(V_m ** 2, dim=0))
    return THD(THD_F=harm / V_m[0], THD_R=harm / total)
