"""Almeida 2010 single-bus harmonically-coupled Norton equivalent case
(the port of :mod:`hpfx.examples.almeida`).

A supply bus with a fixed distorted voltage spectrum feeds one nonlinear
load (a coupled Norton equivalent) through per-harmonic line impedances.
The HCNE device model is linear in V, so the network solves in closed
form:

    (diag(Y_line) + Y_N)·V_l = I_N + diag(Y_line)·V_s
    I_s = Y_line∘(V_s − V_l)

THD is computed on magnitudes (the reference's THD_v at :132 operates on
raw complex components and flags itself "correct? no").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import cx
from ..cx import Cx
from ..devices import _as_cx


class TwoPortSolution(NamedTuple):
    V_load: Cx            # (H,) load-bus voltage spectrum
    I_supply: Cx          # (H,) supply current spectrum
    thd_v: torch.Tensor   # scalar, voltage THD at the load bus


def linear_hcne_twoport(Y_line, I_N, Y_N, V_supply,
                        device=None) -> TwoPortSolution:
    """Solve the supply → line → HCNE-load two-port for all harmonics at
    once.  Y_line: (H,) per-harmonic line admittance; I_N: (H,), Y_N:
    (H, H) coupled Norton parameters; V_supply: (H,) applied voltage
    spectrum; complex numpy arrays (put on ``device``, default the CUDA
    card) or ``Cx``."""
    Y_line, I_N, Y_N, V_supply = (_as_cx(a, device)
                                  for a in (Y_line, I_N, Y_N, V_supply))
    H = I_N.shape[0]
    eye = torch.eye(H, dtype=Y_line.dtype, device=Y_line.device)
    A = Y_N + Cx(eye * Y_line.re[:, None], eye * Y_line.im[:, None])
    rhs = I_N + Y_line * V_supply
    V_l = cx.solve(A, rhs)
    I_s = Y_line * (V_supply - V_l)
    mag = V_l.abs()
    thd = torch.sqrt(torch.sum(mag[1:] ** 2)) / mag[0]
    return TwoPortSolution(V_l, I_s, thd)
